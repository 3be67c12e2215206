"""Model zoo of paddle_tpu_torch (counterpart of paddle_tpu/models);
so far: BERT — the encoder and its masked-LM pretraining step — the
MNIST MLP and LeNet-style conv net, ResNet (depths 18 to 152),
SE-ResNeXt (depths 50 to 152), the WMT Transformer's training and
greedy-decode programs, Wide&Deep CTR training, the PTB LSTM language
model, word2vec (the N-gram LM and the skip-gram model under NCE or
hierarchical sigmoid), and the book's fit_a_line, VGG (CIFAR-10),
sentiment conv net, recommender and SRL tagger with its linear-chain
CRF."""
from . import bert  # noqa: F401
from . import book_extra  # noqa: F401
from . import mnist  # noqa: F401
from . import ptb_lm  # noqa: F401
from . import resnet  # noqa: F401
from . import se_resnext  # noqa: F401
from . import transformer  # noqa: F401
from . import wide_deep  # noqa: F401
from . import word2vec  # noqa: F401
