from .trainer import Trainer, build_trainer  # noqa: F401
from .ppo import PPOTrainer, DDPPOTrainer  # noqa: F401
from .dqn import DQNTrainer  # noqa: F401
from .apex import ApexTrainer, ReplayActor  # noqa: F401
from .impala import APPOTrainer, ImpalaTrainer  # noqa: F401
from .es import ARSTrainer, ESTrainer  # noqa: F401
from .pg import A2CTrainer, PGTrainer  # noqa: F401
from .marwil import MARWILTrainer  # noqa: F401
from .sac import SACTrainer  # noqa: F401
from .qmix import QMIXTrainer  # noqa: F401
from .ddpg import DDPGTrainer, TD3Trainer  # noqa: F401
from .a3c import A3CTrainer  # noqa: F401
from .maml import MAMLTrainer  # noqa: F401
from .dyna import DynaTrainer  # noqa: F401
