"""Model zoo of paddle_tpu_torch (counterpart of paddle_tpu/models);
so far: BERT — the encoder and its masked-LM pretraining step — and the
MNIST MLP."""
from . import bert  # noqa: F401
from . import mnist  # noqa: F401
