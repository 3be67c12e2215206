"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The same Fluid v1.7 front end (Program/Block/Operator/Variable, the
``fluid.layers`` builders, ``Executor.run`` over a ``Scope``) with every
op kernel written against ``torch.Tensor`` and the Pallas TPU kernels
replaced by hand-written Hopper kernels (``ops/cuda/``). Entry points run
on the GPU unless the caller asks for ``fluid.CPUPlace()``.

It trains and serves BERT, ResNet-50, LeNet, the MNIST MLP, the WMT
Transformer and Wide&Deep, and saves, loads and serves inference models
through ``fluid.io`` and ``inference`` (the predictor and its pass
pipeline); see ROADMAP.md for what is still queued."""

__version__ = "0.1.0"

from . import ops          # registers the operator set
from . import fluid        # the Fluid-compatible front end
from . import inference    # the predictor
