"""fluid.contrib (counterpart of paddle_tpu/fluid/contrib/). So far:
mixed precision, the legacy decoder API and the contrib layers."""
from . import mixed_precision  # noqa: F401
from . import decoder  # noqa: F401
from . import layers  # noqa: F401
