"""Two probes of chip_smoke.py's DeepLabv3+ card-vs-CPU check (phase 22
(b)), on one card:

    python3 tools/torch_vision_probe.py ops [CROP]
    python3 tools/torch_vision_probe.py depths [BLOCKS ...]

``ops`` runs one interpreted step of DeepLabv3+ (dropout 0) at CROP
(129 by default) on the card and re-runs each op on the CPU on the
card's inputs: the relative difference of each op's outputs. ``depths``
runs, with each number of middle-flow blocks at 129x129, the check
(2 steps on the card and the CPU from one start) and the eval clone's
mean_iou; then, on the card alone, step 1 from one start twice, the
second with every pixel of the image one float32 ulp up, its parameter
grads held to the first's by the check's rule: how far a difference of
rounding size parts the two runs without a second device."""
import importlib.util
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def ops(crop):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import core, executor as ex
    built = cs._md_fixed(lambda: cs.deeplab_program(
        fluid, cs.DL_MIDDLE, 1.0, crop, cs.DL_CLASSES, cs.DL_LR))
    main, startup = built[:2]
    for op in main.global_block().ops:
        if op.type == "dropout":
            op._set_attr("dropout_prob", 0.0)
    exe, scope = cs._fresh(main, startup)
    feed = cs._dl_feed(np.random.RandomState(cs.SEED + 33), 2, crop)
    orig, rows, cpu = ex._interpret_op, [], torch.device("cpu")

    def hooked(op, idx, sc, keys, device, check=False):
        ins = {}
        for n in op.input_arg_names:
            v = sc.find_var(n)
            if v is not None and v.is_initialized() and \
                    isinstance(v.value(), core.LoDTensor):
                ins[n] = v.value().array.detach().cpu().clone()
        written = orig(op, idx, sc, keys, device, check)
        if op.type in ("dropout", "feed", "fetch"):
            return written
        tmp = fluid.Scope()
        for n, t in ins.items():
            tmp.var(n).set_value(fluid.LoDTensor(t))
        orig(op, idx, tmp, keys, cpu, check)
        worst = 0.0
        for n in op.output_arg_names:
            a, b = sc.find_var(n), tmp.find_var(n)
            if a is None or b is None or not b.is_initialized():
                continue
            a = a.value().array.detach().cpu().double()
            b = b.value().array.detach().double()
            if a.shape == b.shape and a.is_floating_point() and a.numel():
                scale = b.abs().max().item() or 1.0
                worst = max(worst, (a - b).abs().max().item() / scale)
        rows.append((op.type, worst))
        return written

    ex._interpret_op = hooked
    core.set_flag("FLAGS_executor_mode", "interpreted")
    exe.run(main, feed=feed, fetch_list=[built[3]], scope=scope)
    cs._log(f"[ops] {len(rows)} ops of a DeepLabv3+ step at {crop}x{crop} "
            f"on {cs._card_line()}, each against the CPU on the card's "
            "inputs, the largest relative difference by op type:")
    for t in sorted({r[0] for r in rows}):
        cs._log(f"[ops]   {t}: {max(r[1] for r in rows if r[0] == t):.3e}")
    return 0


def nudged(small, feed, middle):
    """Step 1 of ``small`` on the card from one start, with the image as
    it is and one ulp up: the grads' worst share of the check's limit."""
    from paddle_tpu_torch import fluid
    main, startup = small[:2]
    block = main.global_block()
    grads = [p.name + "@GRAD" for p in block.all_parameters()
             if block.has_var(p.name + "@GRAD")]
    names = [v.name for v in main.list_vars() if v.persistable]
    exe, scope = cs._fresh(main, startup)
    exe2 = fluid.Executor(fluid.CUDAPlace(0))
    scope2 = cs._clone_scope(scope, names, "cuda")
    up = dict(feed, image=np.nextafter(feed["image"], np.float32(np.inf)))
    a = exe.run(main, feed=feed, fetch_list=[small[3]] + grads, scope=scope)
    b = exe2.run(main, feed=up, fetch_list=[small[3]] + grads, scope=scope2)
    exe.close()
    exe2.close()
    bad, worst, top = cs._md_grads_agree(grads, b[1:], a[1:],
                                         cs._md_noise_grads(block), True)
    cs._log(f"[depths] {middle} middle-flow blocks, the card against "
            f"itself with the image one ulp up: loss {float(a[0][0]):.6f} "
            f"vs {float(b[0][0]):.6f}; {len(grads)} grads, relative L2 "
            f"within {cs.KINK_L2_TOL:g}: the worst {worst[1]} at "
            f"{worst[0]:.3f} of its limit, {len(bad)} beyond it (largest "
            f"grad {top:.3e}) on {cs._card_line()}")


def depths(blocks):
    from paddle_tpu_torch import fluid
    book, bad = cs._CfBook(), 0
    for middle in blocks:
        small = cs._md_fixed(lambda: cs.deeplab_program(
            fluid, middle, 1.0, cs.DL_CHECK_CROP, cs.DL_CLASSES, cs.DL_LR))
        small[2].random_seed = cs.SEED
        feed = cs._dl_feed(np.random.RandomState(cs.SEED + 33),
                           cs.MD_CHECK_BATCH, cs.DL_CHECK_CROP)
        for check in (lambda: cs._md_card_vs_cpu(
                book, f"{middle} middle-flow blocks", small[0], small[1],
                [small[3]], feed, conv=True, tag="[depths]"),
                lambda: cs._vs_eval_exact(book, small, feed)):
            try:
                check()
            except AssertionError as e:
                bad += 1
                cs._log(f"[depths] {middle} blocks: {e}")
        nudged(small, feed, middle)
    return 1 if bad else 0


def main(argv):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._log(f"[card] {cs._card_line()}")
    what, rest = argv[0], argv[1:]
    if what == "ops":
        return ops(int(rest[0]) if rest else cs.DL_CHECK_CROP)
    return depths([int(a) for a in rest] or [1, 2, 4, 8])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
