"""ray_tpu_torch.rllib: reinforcement learning on tasks/actors (reference:
rllib/).

Policies are plain functions on tensor trees in PyTorch, stepping on the
card unless a trainer's config names ``"device": "cpu"``; rollout workers
are actors with vectorized envs; training loops compose the execution ops
the way the reference's execution plans do. Algorithms: PPO, APPO, DD-PPO,
A2C/PG, DQN (+prioritized replay), APEX, IMPALA (+tree aggregation), SAC,
DDPG/TD3, QMIX, MARWIL, ES, ARS, A3C (async hogwild grads), MAML
(second-order meta-gradient through each inner step's graph), Dyna
(learned dynamics + imagined replay). Envs: vectorized
discrete/continuous, MultiAgentEnv with policy mapping, ExternalEnv
serving, TaskBandit task distribution for meta-RL. Weights are numpy trees
in the JAX package's layout, so checkpoints carry across.
"""

from .agents import (  # noqa: F401
    A2CTrainer,
    A3CTrainer,
    ApexTrainer,
    APPOTrainer,
    ARSTrainer,
    DDPGTrainer,
    DDPPOTrainer,
    DQNTrainer,
    DynaTrainer,
    ESTrainer,
    ImpalaTrainer,
    MAMLTrainer,
    MARWILTrainer,
    PGTrainer,
    PPOTrainer,
    QMIXTrainer,
    SACTrainer,
    TD3Trainer,
    Trainer,
    build_trainer,
)
from .external_env import ExternalEnv, ExternalEnvSampler  # noqa: F401
from .offline import JsonReader, JsonWriter  # noqa: F401
from .env import (  # noqa: F401
    CartPole,
    ContinuousEnv,
    Env,
    MoveToTarget,
    MultiAgentBandit,
    MultiAgentEnv,
    StatelessBandit,
    TaskBandit,
    TwoStepGame,
    VectorEnv,
    make_env,
    register_env,
)
from .execution import (  # noqa: F401
    AggregatorActor,
    ConcatBatches,
    LearnerThread,
    ParallelRollouts,
    PrioritizedReplayBuffer,
    ReplayBuffer,
    StoreToReplayBuffer,
    TrainOneStep,
    make_aggregation_tree,
)
from .multi_agent import MultiAgentRolloutWorker, MultiAgentTrainer  # noqa: F401
from .policy import DQNPolicy, Policy, PPOPolicy  # noqa: F401
from .rollout_worker import RolloutWorker  # noqa: F401
from .sample_batch import SampleBatch, compute_gae  # noqa: F401
from .worker_set import WorkerSet  # noqa: F401
