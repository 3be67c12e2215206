"""Model zoo of paddle_tpu_torch (counterpart of paddle_tpu/models);
this slice: the BERT encoder."""
from . import bert  # noqa: F401
