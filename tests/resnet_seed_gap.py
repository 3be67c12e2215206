"""Where the port's and the TPU package's tiny ResNet-18 trajectories part,
seed by seed, on the CPU.

The configuration is test_torch_resnet.py's 4-step one (depth 18, image
64, 4 classes, batch 4, Momentum lr 0.003, one repeated batch). For each
value of the TPU package's ``FLAGS_seed`` (the startup's weights) it prints:

- every trainable parameter's grad at the first step, as max |port - tpu|
  over the grad's largest magnitude: the worst, and every parameter past
  1e-3 of it;
- the 4 losses of both packages and their relative difference, step by
  step;
- every element of a ReLU input that has one sign in the port and the
  other in the TPU package at the first step: the input in both, and the
  grad that the ReLU passes in one package and stops in the other.

Where the first step's grads part only upstream of such a flip, and the
flip is a value within the two packages' rounding of zero, the gap is
rounding at a kink, not a fault of the port.

Run: ``JAX_PLATFORMS=cpu python3 tests/resnet_seed_gap.py [seed ...]``
(default seeds 0 1234 1 2 3).
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from paddle_tpu.fluid import core as jcore  # noqa: E402
from test_torch_resnet import (_build_both, _image_feed, _jax_run,  # noqa
                               _port_run, _resnet)

STEPS = 4


def gap(seed):
    old = jcore.globals_["FLAGS_seed"]
    jcore.globals_["FLAGS_seed"] = seed
    try:
        (tm, ts, _, tf), (jm, js, _, jf) = _build_both(
            _resnet, depth=18, image_size=64, class_dim=4, lr=0.003)
        grads = [p.name + "@GRAD" for p in tm.global_block().all_parameters()
                 if p.trainable]
        relus = [(op.input("X")[0], op.output("Out")[0] + "@GRAD")
                 for op in tm.global_block().ops if op.type == "relu"]
        first = grads + [n for pair in relus for n in pair]
        feed = _image_feed(0, 4, 64, 4)
        init, jouts, _ = _jax_run(jm, js, [feed] * STEPS, [jf[0]] + first)
        _, _, touts = _port_run(tm, ts, init, [feed] * STEPS,
                                [tf[0]] + first)
    finally:
        jcore.globals_["FLAGS_seed"] = old
    got = {n: (np.asarray(t), np.asarray(j))
           for n, t, j in zip(first, touts[0][1:], jouts[0][1:])}
    worst = max((float(np.abs(t - j).max() / np.abs(j).max()), n)
                for n, (t, j) in ((n, got[n]) for n in grads))
    parted = [n[:-len("@GRAD")] for n in grads
              if np.abs(got[n][0] - got[n][1]).max()
              > 1e-3 * np.abs(got[n][1]).max()]
    print(f"FLAGS_seed {seed}: first step's grads, worst max|d|/max|grad| "
          f"{worst[0]:.3e} ({worst[1]}) over {len(grads)} parameters; "
          f"past 1e-3 of their max: {', '.join(parted) or 'none'}")
    for x, g in relus:
        (xt, xj), (_, gj) = got[x], got[g]
        flips = np.flatnonzero((xt > 0) != (xj > 0))
        for i in flips:
            print(f"  ReLU input {x}: element {i} port {xt.flat[i]:.7e} tpu "
                  f"{xj.flat[i]:.7e}; the grad it gates {gj.flat[i]:.5e} "
                  f"(max |grad| there {np.abs(gj).max():.5e}; max|d| of the "
                  f"input over the tensor {np.abs(xt - xj).max():.3e})")
    tl = [float(np.asarray(o[0]).ravel()[0]) for o in touts]
    jl = [float(np.asarray(o[0]).ravel()[0]) for o in jouts]
    for i in range(STEPS):
        print(f"  step {i + 1}: port {tl[i]:.7f} tpu {jl[i]:.7f} "
              f"rel {abs(tl[i] - jl[i]) / abs(jl[i]):.3e}", flush=True)


if __name__ == "__main__":
    for s in [int(a) for a in sys.argv[1:]] or [0, 1234, 1, 2, 3]:
        gap(s)
