"""Checkpoints: read the JAX package's flax ``.msgpack`` payloads.

Counterpart of the load side of the JAX package's ``train/checkpoint.py``:
``load_payload`` returns the raw ``{step, params, batch_stats, opt_state}``
tree that ``save_checkpoint`` wrote, leaves as numpy arrays (bfloat16
leaves as ``torch.bfloat16`` tensors), through the port's own msgpack
reader (``train/_msgpack.py``): neither ``msgpack`` nor ``flax`` is needed.
The torch-native save and resume of training wait for ROADMAP Queue 1
step 7.
"""

from __future__ import annotations

from audioanalysisdetector_tpu_torch.train._msgpack import MsgpackFormatError, msgpack_restore

__all__ = ["MsgpackFormatError", "load_payload"]


def load_payload(path: str) -> dict:
    """Read a checkpoint WITHOUT a template: the raw payload dict."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
