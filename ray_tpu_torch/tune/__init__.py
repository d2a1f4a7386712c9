"""ray_tpu_torch.tune: hyperparameter tuning on tasks/actors.

Reference surface: ``python/ray/tune`` — ``tune.run`` over Trainable
classes or functions, trial schedulers (ASHA, HyperBand, PBT, median
stopping), grid/random search, checkpointing, CSV/JSON logging.
"""

from .checkpoint_manager import Checkpoint, CheckpointManager  # noqa: F401
from .logger import CSVLogger, JsonLogger, Logger  # noqa: F401
from .progress_reporter import CLIReporter, ProgressReporter  # noqa: F401
from .result import (  # noqa: F401
    DONE,
    TIME_TOTAL_S,
    TRAINING_ITERATION,
)
from .sample import (  # noqa: F401
    choice,
    grid_search,
    loguniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from .schedulers import (  # noqa: F401
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import BasicVariantGenerator, SearchAlgorithm, generate_variants  # noqa: F401
from .suggest import BOHBSearcher, SuggestSearcher  # noqa: F401
from .syncer import FunctionSyncer, LocalSyncer, Syncer, get_syncer  # noqa: F401
from .durable_trainable import DurableTrainable, make_durable  # noqa: F401
from .trainable import FunctionTrainable, Trainable, report, wrap_function  # noqa: F401
from .trial import Trial  # noqa: F401
from .trial_executor import RayTrialExecutor  # noqa: F401
from .trial_runner import TrialRunner  # noqa: F401
from .tune import ExperimentAnalysis, register_trainable, run  # noqa: F401

__all__ = [
    "run",
    "SuggestSearcher",
    "BOHBSearcher",
    "Syncer",
    "LocalSyncer",
    "FunctionSyncer",
    "get_syncer",
    "DurableTrainable",
    "make_durable",
    "report",
    "register_trainable",
    "Trainable",
    "FunctionTrainable",
    "wrap_function",
    "Trial",
    "TrialRunner",
    "RayTrialExecutor",
    "ExperimentAnalysis",
    "TrialScheduler",
    "FIFOScheduler",
    "AsyncHyperBandScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "BasicVariantGenerator",
    "SearchAlgorithm",
    "generate_variants",
    "grid_search",
    "sample_from",
    "uniform",
    "loguniform",
    "randint",
    "choice",
    "randn",
    "Checkpoint",
    "CheckpointManager",
    "Logger",
    "JsonLogger",
    "CSVLogger",
    "CLIReporter",
    "ProgressReporter",
]
