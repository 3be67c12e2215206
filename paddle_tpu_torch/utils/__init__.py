"""Helpers shared by the port's ops and tools (counterpart of
paddle_tpu/utils/)."""
