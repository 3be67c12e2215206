"""The detection batch's programs on paddle_tpu_torch against the TPU
package, on the CPU: YOLOv3, MobileNet-SSD and Faster R-CNN with FPN,
chip_smoke.py's user programs of phase 23 (``yolov3_program``,
``ssd_program``, ``faster_rcnn_program``), built in both packages:

- at full width the same op types and parameters;
- at a small depth and width, from the TPU package's start: step 1's
  loss at rtol 1e-4; every parameter's grad, and the update it makes
  (each parameter's move), by chip_smoke's rules for card against CPU
  (``_md_grads_agree``: max|d| within GRAD_TOL of the grad's max|grad|,
  or for the conv nets SSD and Faster R-CNN, whose ReLU kinks move under
  rounding, relative L2 within KINK_L2_TOL; a grad whose max|grad| is
  within GRAD_TOL of the largest grad, as SSD's batch norm scales' at
  1e-5 of it, within GRAD_TOL of the largest; SSD's RMSProp moves but
  where a grad is within GRAD_TOL of its own largest, nor of the
  parameters whose grads were held as rounding); the port's compiled
  (YOLOv3) or segmented (SSD, Faster R-CNN: the host ops are islands)
  run bitwise its interpreter's; YOLOv3's and SSD's eval programs from
  the updated state, their detections and SSD's mAP exactly (Faster
  R-CNN's eval program is built and compared at full width: the TPU
  package's XLA compiles of a second program of it take a minute here;
  SSD and Faster R-CNN are test_torch_detection_ssd.py's and
  test_torch_detection_frcn.py's, each file's time under a minute);
- the host ops under ``chip_smoke.IslandTape``: the TPU package's
  islands are recorded and the port's replay them, each port island run
  on the recorded inputs giving the recorded outputs exactly, so a
  selection that a last-bit difference of the dense layers before it
  would part (an NMS near-tie) cannot part what follows; the selections
  that parted on the port's own inputs are counted and the islands'
  float inputs held at rtol 1e-4 in relative L2 (after the update, in
  the eval program, at KINK_L2_TOL: an adaptive update amplifies the
  rounding of the grads it divides).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tests.test_torch_models_a7 import _j_feed, _persistables, _t_feed
from tests.test_torch_rnn_layers import cs
from tests.test_torch_vision_models import (_Pair, _agree, _both, _params,
                                            _types)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pin_seed():
    old = jcore.globals_["FLAGS_seed"]
    jcore.globals_["FLAGS_seed"] = 0
    yield
    jcore.globals_["FLAGS_seed"] = old


class _TapedPair(_Pair):
    """``_Pair`` whose runs go the TPU package first, its host ops
    recorded, then the port compiled or segmented and interpreted, each
    replaying them (``IslandTape``)."""

    def run(self, jmain, tmain, feed, jfetch, tfetch, mode="segmented",
            inputs_tol=RTOL):
        self.tape = tape = cs.IslandTape()
        with jfluid.scope_guard(self.jscope), \
                tape.recording(JOPS, np.asarray):
            jout = self.jexe.run(jmain, feed=_j_feed(feed),
                                 fetch_list=jfetch)
        with tape.replaying(TOPS, cs._det_cpu_from_np, cs._det_card_np):
            tout = self.texe.run(tmain, feed=_t_feed(feed),
                                 fetch_list=tfetch, scope=self.tscope,
                                 return_numpy=False)
            assert self.texe._last_run_mode == mode
            tape.rewind()
            tcore.set_flag("FLAGS_executor_mode", "interpreted")
            try:
                iout = self.texe.run(tmain, feed=_t_feed(feed),
                                     fetch_list=tfetch, scope=self.iscope,
                                     return_numpy=False)
            finally:
                tcore.set_flag("FLAGS_executor_mode", "compiled")
        for a, b in zip(tout, iout):
            assert np.array_equal(a.numpy(), b.numpy()), \
                "compiled vs interpreted"
        assert tape.input_rel_l2 <= inputs_tol, tape.input_rel_l2
        return [np.asarray(v) for v in jout], [v.numpy() for v in tout]


# ---------------------------------------------------- full-width builds
FULL = [("yolov3", cs.yolov3_program), ("ssd", cs.ssd_program),
        ("faster_rcnn", cs.faster_rcnn_program)]


@pytest.mark.parametrize("name,build", FULL, ids=[f[0] for f in FULL])
def test_programs_equal_the_tpu_package_at_full_width(name, build):
    j, t = _both(build)
    for jp, tp in ((j[0], t[0]), (j[2], t[2])):
        assert _types(tp) == _types(jp)
        assert _params(tp) == _params(jp)


# ------------------------------------------------------- the three runs
SMALL = {
    "yolov3": (cs.yolov3_program,
               dict(depth=(0, 0, 0, 0, 0), width=1 / 16, image=64,
                    classes=3, boxes=3)),
    "ssd": (cs.ssd_program, dict(depth=1, width=1 / 4, image=96,
                                 classes=5)),
    "faster_rcnn": (cs.faster_rcnn_program,
                    dict(depth=(1, 1, 1, 1), width=1 / 16,
                         image=(128, 192), classes=5, proposals=(100, 50),
                         rois=24)),
}


def _feed(name, rng):
    kw = SMALL[name][1]
    if name == "yolov3":
        return cs.yolo_feed(rng, 2, kw["image"], kw["classes"],
                            kw["boxes"], (1, 6))
    if name == "ssd":
        return cs.ssd_feed(rng, 3, kw["image"], kw["classes"])
    return cs.frcn_feed(rng, kw["image"], kw["classes"], (1, 5))


def _eval_feed(name, feed):
    if name == "yolov3":
        n, _, h, w = feed["image"].shape
        return {"image": feed["image"],
                "im_size": np.array([[h, w]] * n, np.int32)}
    return feed


def _held(what, names, port, ref, block, conv):
    bad, worst, _ = cs._md_grads_agree(names, port, ref,
                                       cs._md_noise_grads(block), conv,
                                       tiny=True)
    assert not bad, f"{what}: {bad[:6]}, the worst {worst}"


def step_and_eval(name):
    """Step 1 of ``name`` in both packages from the TPU package's start
    (``_TapedPair``): the loss, every grad and each parameter's move;
    then, but for Faster R-CNN, the eval program from the updated state.
    → the selections that parted on the port's own inputs."""
    build, kw = SMALL[name]
    j, t = _both(build, **kw)
    mode = "compiled" if name == "yolov3" else "segmented"
    conv = name != "yolov3"
    pair = _TapedPair([j[1]], [t[1]], _persistables(j[0]))
    block = t[0].global_block()
    params = [p.name for p in block.all_parameters()
              if block.has_var(p.name + "@GRAD")]
    start = {n: np.asarray(pair.jscope.find_var(n).get_tensor().array)
             for n in params}
    feed = _feed(name, np.random.RandomState(20))
    g = [n + "@GRAD" for n in params]
    jo, to = pair.run(j[0], t[0], feed, [j[3]] + g, [t[3]] + g, mode=mode)
    np.testing.assert_allclose(to[0], jo[0], rtol=RTOL)
    assert np.isfinite(to[0]).all()
    _held(f"{name} step 1's grads", g, to[1:], jo[1:], block, conv)
    pair.same_state(t[0], reference=False)
    moves = [[np.asarray(get(n), np.float64) - start[n] for n in params]
             for get in (lambda n: pair.tscope.find_var(n).value().array,
                         lambda n: pair.jscope.find_var(n).get_tensor()
                         .array)]
    if name == "ssd":
        # RMSProp's g / sqrt(mean g²) turns a near-zero grad's rounding
        # into a step of ±lr: those elements' moves are not compared
        for k, gr in enumerate(jo[1:]):
            keep = np.abs(gr) > cs.GRAD_TOL * np.abs(gr).max()
            moves[0][k], moves[1][k] = moves[0][k] * keep, moves[1][k] * keep
    if name == "ssd":
        # nor the params whose grads were held as rounding: RMSProp steps
        # each element ±lr·√20 by its grad's sign
        top = max(np.abs(b).max() for b in jo[1:])
        kept = [k for k, b in enumerate(jo[1:])
                if np.abs(b).max() > cs.GRAD_TOL * top]
        g = [g[k] for k in kept]
        moves = [[m[k] for k in kept] for m in moves]
    _held(f"{name} step 1's update", g, *moves, block, conv)
    held, parted = pair.tape.held, pair.tape.parted
    assert held >= (0 if name == "yolov3" else 3)
    if name != "faster_rcnn":
        # the eval program from the updated state: its detections (and
        # SSD's mAP) exactly as the TPU package's islands gave them
        jo, to = pair.run(j[2], t[2], _eval_feed(name, feed),
                          list(j[4:]), list(t[4:]),
                          inputs_tol=cs.KINK_L2_TOL)
        _agree(jo, to, f"{name} eval", exact=range(len(to)))
        assert pair.tape.held >= 1
        parted += pair.tape.parted
    return parted


def test_step_and_eval_against_the_tpu_package():
    step_and_eval("yolov3")
