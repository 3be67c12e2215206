"""fluid.contrib (counterpart of paddle_tpu/fluid/contrib/). So far:
mixed precision."""
from . import mixed_precision  # noqa: F401
