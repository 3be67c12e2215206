"""fluid.layers — op-builder functions (counterpart of
paddle_tpu/fluid/layers/). Each function appends ops to the current
program block and returns its output Variables."""
from .nn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from . import detection  # noqa: F401
from .detection import *  # noqa: F401,F403
