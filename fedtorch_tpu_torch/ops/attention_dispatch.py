"""Attention backend dispatch policy (a copy of
``fedtorch_tpu/ops/attention_dispatch.py``; the port imports nothing of
the JAX package, not even this pure-Python module).

``'auto'`` picks the flash kernel from ``FLASH_MIN_SEQ_LEN`` up, the
threshold the JAX package set from its own on-chip training A/B on a
TPU; the port keeps the same policy so both packages route a model the
same way. Explicit ``'dense'`` and ``'flash'`` pass through.
"""
from __future__ import annotations

# shortest sequence length at which 'auto' picks the flash kernel
FLASH_MIN_SEQ_LEN = 4096


def resolve_attention(mode: str, seq_len: int) -> str:
    """Resolve an attention mode ('auto'|'dense'|'flash') for a static
    sequence length."""
    if mode == "auto":
        return "flash" if seq_len >= FLASH_MIN_SEQ_LEN else "dense"
    if mode not in ("dense", "flash"):
        raise ValueError(
            f"attention must be 'auto', 'dense' or 'flash', got {mode!r}")
    return mode
