from .trainer import Trainer, build_trainer  # noqa: F401
from .ppo import PPOTrainer, DDPPOTrainer  # noqa: F401
from .dqn import DQNTrainer  # noqa: F401
from .apex import ApexTrainer, ReplayActor  # noqa: F401
from .impala import APPOTrainer, ImpalaTrainer  # noqa: F401
from .es import ARSTrainer, ESTrainer  # noqa: F401
from .pg import A2CTrainer, PGTrainer  # noqa: F401
from .a3c import A3CTrainer  # noqa: F401
