"""fluid.install_check: the post-install check (counterpart of
paddle_tpu/fluid/install_check.py; reference:
python/paddle/fluid/install_check.py run_check)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["run_check"]


def run_check(place=None):
    """Train one SGD step of a 2-feature linear model (fc to 4, mean) on
    ``place`` (default: the card, ``CUDAPlace(0)``), check that the loss
    is finite, and print the verdict. The reference's multi-device leg
    (a data-parallel run over every device) is ROADMAP A8: with more than
    one CUDA device it raises NotImplementedError naming it; at one it
    has nothing to run. → the loss."""
    from .. import fluid
    place = fluid.CUDAPlace(0) if place is None else place
    dev = place.torch_device()
    prog, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.data("inp", shape=[2], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 4))
        fluid.optimizer.SGD(0.01).minimize(loss)
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    (val,) = exe.run(prog, feed={"inp": np.ones((2, 2), np.float32)},
                     fetch_list=[loss.name], scope=scope)
    if not np.all(np.isfinite(val)):
        raise RuntimeError(f"install check: the loss is not finite ({val})")
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_dev > 1:
        raise NotImplementedError(
            f"install check: {n_dev} CUDA devices; the multi-device leg "
            "(data parallelism) is not ported to paddle_tpu_torch yet "
            "(ROADMAP A8)")
    print("Your paddle-tpu is installed successfully! Let's start deep "
          "Learning with paddle-tpu now")
    return val
