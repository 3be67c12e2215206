"""fluid.contrib (counterpart of paddle_tpu/fluid/contrib/). So far:
mixed precision and the legacy decoder API."""
from . import mixed_precision  # noqa: F401
from . import decoder  # noqa: F401
