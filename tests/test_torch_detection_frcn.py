"""Faster R-CNN with FPN, chip_smoke.py's ``faster_rcnn_program`` of
phase 23, on paddle_tpu_torch against the TPU package on the CPU at a
small depth and width (test_torch_detection_models.py's rules): step 1's
loss, every parameter's grad and each parameter's move, the port's
segmented step bitwise its interpreter's, the host ops (the RPN's
anchor sampler, the five proposal generators, the FPN collection and
distribution, the RoI sampler) replayed from the TPU package's and held
exactly on its inputs. A file of its own to keep each file's time under
a minute, as test_torch_detection_ssd.py."""
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


def test_step_against_the_tpu_package():
    step_and_eval("faster_rcnn")
