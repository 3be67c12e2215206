"""MobileNet-SSD, chip_smoke.py's ``ssd_program`` of phase 23, on
paddle_tpu_torch against the TPU package on the CPU at a small depth and
width (test_torch_detection_models.py's rules): step 1's loss, every
parameter's grad and each parameter's RMSProp move, the port's
segmented step bitwise its interpreter's, the matching islands
(bipartite_match, target_assign) replayed from the TPU package's and
held exactly on its inputs; then the eval program (detection_output and
detection_map) from the updated state, its detections and mAP exactly.
A file of its own to keep each file's time under a minute."""
import pytest
import torch

from paddle_tpu.fluid import core as jcore
from tests.test_torch_detection_models import step_and_eval


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


def test_step_and_eval_against_the_tpu_package():
    step_and_eval("ssd")
