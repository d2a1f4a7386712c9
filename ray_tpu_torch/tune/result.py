"""Standard result keys (reference: python/ray/tune/result.py)."""

import os
import tempfile

TRAINING_ITERATION = "training_iteration"
TIME_TOTAL_S = "time_total_s"
TIME_THIS_ITER_S = "time_this_iter_s"
TIMESTEPS_TOTAL = "timesteps_total"
EPISODE_REWARD_MEAN = "episode_reward_mean"
MEAN_LOSS = "mean_loss"
MEAN_ACCURACY = "mean_accuracy"
TRIAL_ID = "trial_id"
EXPERIMENT_TAG = "experiment_tag"
DONE = "done"

DEFAULT_RESULTS_DIR = os.path.join(tempfile.gettempdir(),
                                   "ray_tpu_torch_results")
