"""Model zoo of paddle_tpu_torch (counterpart of paddle_tpu/models);
so far: BERT — the encoder and its masked-LM pretraining step — the
MNIST MLP and LeNet-style conv net, ResNet (depths 18 to 152), the
WMT Transformer's training and greedy-decode programs, Wide&Deep
CTR training, and the book's fit_a_line, sentiment conv net and
recommender."""
from . import bert  # noqa: F401
from . import book_extra  # noqa: F401
from . import mnist  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
from . import wide_deep  # noqa: F401
