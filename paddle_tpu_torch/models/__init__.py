"""Model zoo of paddle_tpu_torch (counterpart of paddle_tpu/models);
so far: BERT — the encoder and its masked-LM pretraining step — the
MNIST MLP and LeNet-style conv net, ResNet (depths 18 to 152), and the
WMT Transformer's training and greedy-decode programs."""
from . import bert  # noqa: F401
from . import mnist  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
