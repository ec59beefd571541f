"""Single-chip sort API: sort / argsort / sort_pairs and their dtype and
multi-column variants.

Role-wise this is RadX's L4 "Sort API layer" (radx::Sort<Radix>::initialize/
command, radx_internal.hpp:104-134): it owns buffer preparation (the
order-preserving key encodings) and dispatches to one engine, the stable
``lax.sort`` of ops/core.py, which XLA's GPU backend lowers to CUB's LSD
radix sort — the design RadX itself implements (SURVEY §1).

Unlike the reference (keys only; its payload pipelines are created but never
dispatched, radx_internal.hpp:139), payload sorting and stable argsort are
first-class here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from radx_tpu.ops import core


def _as_u32(keys):
    keys = jnp.asarray(keys)
    if keys.dtype != jnp.uint32:
        raise TypeError(f"keys must be uint32, got {keys.dtype}")
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    return keys


def _as_payload(payload, keys, what="payload"):
    payload = jnp.asarray(payload)
    if payload.shape != keys.shape:
        raise ValueError(f"{what} must match keys shape")
    if payload.dtype.itemsize != 4:
        raise TypeError(f"{what} must be 32-bit dtypes")
    return payload


@jax.jit
def _sort_jit(keys):
    return jax.lax.sort(keys)


@jax.jit
def _argsort_jit(keys):
    return core.argsort_stable(keys)[1]


@jax.jit
def _sort_pairs_jit(keys, payload):
    return core.sort_pairs_stable(keys, payload)


@jax.jit
def _sort_multi_jit(keys, payloads):
    return core.sort_by_key(keys, list(payloads))


@jax.jit
def _sort_u64_jit(hi, lo):
    perm = core.lex_argsort([hi, lo])
    return hi[perm], lo[perm]


@jax.jit
def _sort_pairs_u64_jit(hi, lo, payload):
    perm = core.lex_argsort([hi, lo])
    return hi[perm], lo[perm], payload[perm]


def sort(keys):
    """Ascending sort of 1-D uint32 keys (any length)."""
    keys = _as_u32(keys)
    if keys.shape[0] <= 1:
        return keys
    return _sort_jit(keys)


def argsort(keys):
    """Stable argsort: int32 permutation, ties keep original order."""
    keys = _as_u32(keys)
    if keys.shape[0] <= 1:
        return jnp.zeros(keys.shape, jnp.int32)
    return _argsort_jit(keys)


def sort_pairs(keys, payload):
    """Stable key+payload sort — the capability RadX stubs but never ships
    (indiction/permutation dispatches absent from Radix::command,
    radx_implement.inl:421-447).  payload: any 32-bit dtype."""
    keys = _as_u32(keys)
    payload = _as_payload(payload, keys)
    if keys.shape[0] <= 1:
        return keys, payload
    return _sort_pairs_jit(keys, payload)


def sort_multi(keys, payloads):
    """Stable sort of uint32 keys carrying any number of 32-bit payload
    columns.  Returns (sorted_keys, payloads_out)."""
    keys = _as_u32(keys)
    payloads = [_as_payload(p, keys, "payloads") for p in payloads]
    if not payloads:
        return sort(keys), []
    if keys.shape[0] <= 1:
        return keys, payloads
    return _sort_multi_jit(keys, tuple(payloads))


def sort_u64(hi, lo):
    """Sort 64-bit keys given as (hi, lo) uint32 halves, lexicographically.
    Returns sorted (hi, lo)."""
    hi = _as_u32(hi)
    lo = _as_u32(lo)
    if hi.shape != lo.shape:
        raise ValueError("hi/lo must match")
    if hi.shape[0] <= 1:
        return hi, lo
    return _sort_u64_jit(hi, lo)


_SIGN64 = np.uint64(0x8000000000000000)
_WIDE = (np.dtype(np.uint64), np.dtype(np.int64), np.dtype(np.float64))


def _encode_keys64(keys: np.ndarray) -> np.ndarray:
    """Order-preserving uint64 encoding of 64-bit key dtypes (numpy side:
    JAX runs x32 here, so 64-bit keys are split into two uint32 halves
    before they ever reach a device).  Same construction as
    core.encode_keys: uint64 identity, int64 sign-bit flip, float64
    sign-magnitude to lexicographic (total order -inf < ... < -0.0 < +0.0
    < ... < +inf < nan, matching np.sort's nan-last placement)."""
    if keys.dtype == np.uint64:
        return keys
    if keys.dtype == np.int64:
        return keys.view(np.uint64) ^ _SIGN64
    bits = keys.view(np.uint64)
    return np.where((bits & _SIGN64) != 0, ~bits, bits | _SIGN64)


def _decode_keys64(enc: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint64:
        return enc
    if dtype == np.int64:
        return (enc ^ _SIGN64).view(np.int64)
    bits = np.where((enc & _SIGN64) != 0, enc ^ _SIGN64, ~enc)
    return bits.view(np.float64)


def _split64(keys: np.ndarray, descending: bool):
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    enc = _encode_keys64(keys)
    if descending:
        enc = ~enc
    return (
        (enc >> np.uint64(32)).astype(np.uint32),
        (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def _join64(hi, lo, descending: bool, dtype) -> np.ndarray:
    out = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)
    if descending:
        out = ~out
    return _decode_keys64(out, dtype)


def _wide(keys) -> bool:
    return isinstance(keys, np.ndarray) and keys.dtype in _WIDE


def sort_any(keys, descending: bool = False):
    """Sort uint32 / int32 / float32 / uint64 / int64 / float64 keys
    (ascending or descending).

    Implemented by order-preserving bit encodings over the uint32 engine —
    the reference supports uint32 only (SURVEY §2); wider dtype coverage is
    part of the query-executor surface.  64-bit dtypes take numpy arrays
    (x32 JAX would silently truncate them) and run through the two-column
    lexicographic sort (sort_u64)."""
    if _wide(keys):
        hi, lo = _split64(keys, descending)
        return _join64(*sort_u64(hi, lo), descending, keys.dtype)
    keys = jnp.asarray(keys)
    enc = core.encode_keys(keys)
    if descending:
        enc = ~enc
    out = sort(enc)
    if descending:
        out = ~out
    return core.decode_keys(out, keys.dtype)


def sort_pairs_any(keys, payload, descending=False):
    """Stable key+payload sort for uint32 / int32 / float32 keys, plus
    uint64 / int64 / float64 numpy keys (x32 JAX would truncate them; the
    64-bit path sorts the two uint32 halves lexicographically).  ±0.0 float
    keys order as -0.0 < +0.0 (the same total order as the 32-bit float
    path)."""
    if _wide(keys):
        hi, lo = _split64(keys, descending)
        payload = _as_payload(payload, jnp.asarray(hi))
        if hi.shape[0] <= 1:
            return keys, payload
        sh, sl, sp = _sort_pairs_u64_jit(hi, lo, payload)
        return _join64(sh, sl, descending, keys.dtype), sp
    keys = jnp.asarray(keys)
    enc = core.encode_keys(keys)
    if descending:
        enc = ~enc
    k, p = sort_pairs(enc, payload)
    if descending:
        k = ~k
    return core.decode_keys(k, keys.dtype), p
