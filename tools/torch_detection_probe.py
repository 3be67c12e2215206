"""chip_smoke.py's phase 23 (the detection batch) alone, or its parts, on
one card:

    python3 tools/torch_detection_probe.py [PART ...]

PART is ``yolov3``, ``ssd``, ``faster_rcnn`` (the main path's programs,
trained and evaluated at their published widths), ``checks`` (card
against CPU under the island tape), ``battery`` (the 44 op types against
the CPU port) or ``phase`` (phase_detection whole, its launch gates
included); by default ``phase``. Prints chip_smoke's lines, each part's
seconds and the card's name and power limit."""
import importlib.util
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PARTS = {
    "yolov3": lambda: cs._det_yolo(cs._CfBook()),
    "ssd": lambda: cs._det_ssd(cs._CfBook()),
    "faster_rcnn": lambda: cs._det_frcn(cs._CfBook()),
    "checks": lambda: cs._det_checks(cs._CfBook()),
    "battery": lambda: cs._vs_battery_run(cs._CfBook(), cs._det_battery(),
                                          tag=cs.DET_TAG,
                                          exact=cs.DET_HOST_OPS),
    "phase": cs.phase_detection,
}


def main(argv):
    if not torch.cuda.is_available():
        print("torch_detection_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._log(f"[card] {cs._card_line()}")
    for part in argv or ["phase"]:
        t = time.perf_counter()
        PARTS[part]()
        cs._log(f"[time] {part} in {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
