"""Serving: the prefill and decode functions of a model.

The port of ``repro.training.serve.build_serve_fns``. The reference's
``decode_state_specs`` and ``batch_axes`` place the decode state on a GSPMD
mesh (batch over "data", cache slots and recurrent heads over "model"); the
port serves on one card and has no counterpart of them.
"""

from __future__ import annotations

from typing import Callable, Tuple

__all__ = ["build_serve_fns"]


def build_serve_fns(model, *, seq_len: int) -> Tuple[Callable, Callable]:
    """Returns (prefill_fn, decode_fn):

    prefill_fn(params, batch)             -> (last logits (B, V), decode state)
    decode_fn(params, state, token, pos)  -> (logits (B, V), state)

    The state holds a ``seq_len`` context; ``decode_fn`` writes it in place
    and takes ``pos`` as a Python int.
    """

    def prefill_fn(params, batch):
        return model.prefill(params, batch, seq_len)

    def decode_fn(params, state, token, pos: int):
        return model.decode_step(params, state, token, pos)

    return prefill_fn, decode_fn
