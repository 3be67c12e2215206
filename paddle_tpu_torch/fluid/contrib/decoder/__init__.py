"""contrib.decoder (counterpart of paddle_tpu/fluid/contrib/decoder/;
reference: contrib/decoder/beam_search_decoder.py)."""
from .beam_search_decoder import (InitState, StateCell, TrainingDecoder,
                                  BeamSearchDecoder)

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]
