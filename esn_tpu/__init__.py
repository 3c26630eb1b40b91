"""esn_tpu — efficient semantic segmentation on JAX/XLA.

From-scratch JAX/XLA/Pallas rebuild of the capability surface of the
Efficient-Segmentation-Networks PyTorch zoo (see SURVEY.md). Public API:

    from esn_tpu.models import build_model, available_models
    from esn_tpu import nn                       # functional module calculus
    from esn_tpu.train.trainer import Trainer, TrainConfig
    from esn_tpu.train import losses, metrics, schedules, optimizers
    from esn_tpu.data import builders            # dataset/loader factories
    from esn_tpu.parallel import mesh, spatial   # DP + spatial sharding
"""

__version__ = "0.1.0"

from . import nn  # noqa: F401
from .models import available_models, build_model  # noqa: F401
