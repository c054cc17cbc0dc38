"""PyTorch checkpoint files as dicts of numpy arrays.

Counterpart of ``lightgrad_tpu/utils/torch_loader.py`` and
``torch_saver.py``, which read and write the torch zip (and the legacy
stream) format without torch.  The port has torch, so both are thin
wrappers over ``torch.load(weights_only=True)`` and ``torch.save``.
A bfloat16 tensor comes back as float32, as ``CudaTensor.numpy()`` gives
it: numpy has no bfloat16.
"""

import io
import os
import tempfile

import numpy as np
import torch

__all__ = ["load_torch_state_dict", "save_torch_state_dict"]


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_torch_state_dict(data: bytes) -> dict:
    """The ``{name: np.ndarray}`` of a pytorch checkpoint's bytes."""
    state = torch.load(io.BytesIO(data), map_location="cpu",
                       weights_only=True)
    return {k: _numpy(v) for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def save_torch_state_dict(state: dict, path: str,
                          archive_name: str = "archive"):
    """Write ``{name: np.ndarray}`` (or tensors) as a torch-zip checkpoint
    at ``path``; ``archive_name`` is the folder inside the zip."""
    out = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(np.asarray(v))))
           for k, v in state.items()}
    # torch.save names the zip's folder after the file it writes
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(path))) as tmp:
        stem = os.path.join(tmp, archive_name)
        torch.save(out, stem)
        os.replace(stem, path)
