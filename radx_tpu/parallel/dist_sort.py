"""Distributed sample-splitter sort over a device mesh (BASELINE config 5).

Net-new capability vs the reference (which is strictly single-GPU,
SURVEY §2e).  Every step is a plain XLA op or collective: stable sorts,
contiguous dynamic slices, comparisons/reductions, and `ppermute` /
`all_gather`.  Algorithm per shard:

  1. **local sort first** — a stable sort by key (CUB's radix sort on the
     GPU); payloads ride by one gather each;
  2. **sample splitters**: regular samples from the *sorted* shard are
     `all_gather`ed (tiny) and sorted; D-1 splitter *keys* are picked at
     regular ranks.  Classic sample-sort balance bound: each device
     receives at most N/D + N/oversample keys under *any* distribution
     (the reference never handles skew at all, it uses fixed blocks);
  3. run boundaries in the sorted shard = D-1 "rank of splitter"
     reductions; packing into fixed slots = D contiguous dynamic slices;
  4. **exchange as D-1 `ppermute` waves**.  `exchange="hier"` instead runs
     a two-phase exchange over the Dr×Dc factorization of D —
     (Dr-1)+(Dc-1) ≈ 2√D-2 waves instead of D-1, each key crossing the
     wire twice (route to the destination *block* along column peers,
     sort, re-slice at the block's internal splitters, deliver along row
     peers);
  5. the received slots are sorted once more, into one run.

  The concatenation of device 0's valid prefix, device 1's, ... is the
  globally sorted sequence.

Capacity: slots are static (XLA requires static shapes), the pow2 round-up
of `capacity` × ceil(N/D²) keys per (src, dst) pair.  Overflow cannot be
raised from inside jit, so the sort also returns a boolean overflow flag
computed with a global max — callers must check it (tested in
tests/test_dist_sort.py).

Payloads ride along through the local sort, the slices, the waves, and the
final sorts — the distributed analogue of the reference's never-dispatched
indiction/permutation payload stubs (radix/indiction.comp:22-28).  Payload
sorts carry a global-index column and order by (key, global index), so they
are stable across the whole mesh and never confuse a real 0xFFFFFFFF key
with slot padding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from radx_tpu.config import cdiv
from radx_tpu.ops import core

SLOT_ALIGN = 128  # smallest slot, in keys
_KEY_PAD = np.uint32(0xFFFFFFFF)
_IDX_PAD = np.int32(0x7FFFFFFF)
OVERSAMPLE = 64  # samples per device per splitter; recv bound N/D + N/(64·D)


def _pow2_pad(n: int, min_total: int = 1024) -> int:
    return 1 << (max(n, min_total) - 1).bit_length()


def _plane_fill(i, num_cmp, dtype):
    """Slot padding per column: the maximum key, and the maximum global
    index, so padding sorts behind every real row of an equal key."""
    if i == 0:
        return _KEY_PAD
    if i == 1 and num_cmp == 2:
        return _IDX_PAD
    return np.zeros((), dtype)


def _sort_planes(planes, num_cmp):
    """Sort [key, (global index), payloads...] by key, or by (key, global
    index) when num_cmp == 2."""
    if len(planes) == 1:
        return [jax.lax.sort(planes[0])]
    if num_cmp == 2:
        perm = core.lex_argsort(planes[:2])
        return [p[perm] for p in planes]
    sk, rest = core.sort_by_key(planes[0], planes[1:])
    return [sk, *rest]


def _pack_slots(planes, bounds, counts, group_size, slot, num_cmp):
    """Pack contiguous runs [bounds[g], bounds[g+1]) of sorted planes into
    fixed padded slots — one (G, slot) array per plane."""
    j = jax.lax.broadcasted_iota(jnp.int32, (group_size, slot), 1)
    in_slot = j < counts[:, None]
    send = []
    for i, p in enumerate(planes):
        fill = _plane_fill(i, num_cmp, p.dtype)
        padded = jnp.concatenate([p, jnp.full((slot,), fill, p.dtype)])
        rows = jnp.stack([
            jax.lax.dynamic_slice(padded, (bounds[s],), (slot,))
            for s in range(group_size)
        ])
        send.append(jnp.where(in_slot, rows, fill))
    return send


def _group_exchange(send, counts, axis, me_g, group_size, group_sel,
                    num_cmp):
    """Exchange fixed slots within a device subgroup and sort the arrivals.

    send: one (G, slot) array per plane — slot g is bound for the group's
    g-th device; counts: (G,) valid lengths; group_sel[i] = (g, flat_of)
    maps a flat axis index to its group coordinate and back (defines the
    subgroup permutation for ppermute).  Returns (sorted planes of G·slot
    rows, the valid total); padding sorts behind every real row.

    Shared by the flat exchange and both phases of the hierarchical one.
    """

    def wave_perm(shift):
        return [
            (i, flat_of[(g + shift) % group_size])
            for i, (g, flat_of) in group_sel.items()
        ]

    def take(x, g):
        return jax.lax.dynamic_index_in_dim(x, g, keepdims=False)

    runs = [[take(p, me_g) for p in send]]
    valid = take(counts, me_g)
    for shift in range(1, group_size):
        dest = (me_g + shift) % group_size
        perm = wave_perm(shift)
        runs.append(jax.lax.ppermute([take(p, dest) for p in send], axis, perm))
        valid = valid + jax.lax.ppermute(take(counts, dest), axis, perm)
    planes = [jnp.concatenate(col) for col in zip(*runs)]
    return _sort_planes(planes, num_cmp), valid


def _shard_body(keys, payloads, n_dev, slot, n, axis, num_cmp, hier=None):
    """Per-shard body (runs under shard_map). keys: (m,) uint32.

    hier=None: flat exchange (D-1 waves, slot = int).  hier=(Dr, Dc):
    two-phase hierarchical exchange (slot = (slot1, slot2) pow2 sizes).
    num_cmp == 2 carries a global-index column (payload sorts).

    n is the GLOBAL valid count: ragged inputs are padded to D·m by the
    wrapper, pads sit at the global tail, so this shard's valid prefix is
    m_valid = clip(n - me·m, 0, m).  Pads never enter samples, counts, or
    the exchange — they are simply not sliced."""
    m = keys.shape[0]
    me = jax.lax.axis_index(axis)
    m_valid = jnp.clip(n - me * m, 0, m)

    # (1) local sort: stable by key, so rows of equal key stay in global
    # index order and the valid prefix stays ahead of the ragged pads
    planes = [keys]
    if num_cmp == 2:
        planes.append(me * m + jnp.arange(m, dtype=jnp.int32))
    planes = _sort_planes(planes + list(payloads), 1)
    s_key = planes[0]

    # (2) sample splitters from the sorted shard's VALID prefix.  Exact
    # i32 arithmetic: (j+1)*m_valid overflows i32 at 64·n >= 2^31, so
    # split m_valid = q·(ns+1) + r (j·r <= (ns+1)² stays small).
    ns = OVERSAMPLE * n_dev
    jj = jnp.arange(ns, dtype=jnp.int32) + 1
    q, r = m_valid // (ns + 1), m_valid % (ns + 1)
    pos = jj * q + (jj * r) // (ns + 1)
    samples = s_key[pos]
    gsamples = jax.lax.all_gather(samples, axis, tiled=True)  # (ns·D,)
    gsorted = jnp.sort(gsamples)
    spos = jnp.arange(1, n_dev, dtype=jnp.int32) * ns  # = j·(ns·D)//D exactly
    splitters = gsorted[spos]  # (D-1,) — device s gets [split[s-1], split[s])

    def split_bounds(sorted_key, valid_len, split_vals):
        """Run boundaries at the splitters within the valid prefix (pads
        are the maximum key and would otherwise count into the top
        splitter's run when a splitter equals it)."""
        ranks = [
            jnp.minimum(jnp.sum(sorted_key < sv, dtype=jnp.int32), valid_len)
            for sv in split_vals
        ]
        bounds = jnp.stack([jnp.int32(0), *ranks, valid_len])
        return bounds, bounds[1:] - bounds[:-1]

    if hier is None:
        # (3) flat: D runs at final-splitter boundaries, D-1 waves
        bounds, counts = split_bounds(
            s_key, m_valid, [splitters[s] for s in range(n_dev - 1)]
        )
        overflow = jax.lax.pmax(jnp.max(counts - slot), axis) > 0
        send = _pack_slots(planes, bounds, counts, n_dev, slot, num_cmp)
        flat_sel = {i: (i, list(range(n_dev))) for i in range(n_dev)}
        merged, valid = _group_exchange(
            send, counts, axis, me, n_dev, flat_sel, num_cmp
        )
    else:
        # (3') hierarchical two-phase exchange: factor the axis as
        # D = Dr x Dc (me = r·Dc + c).  Phase 1 routes by dest BLOCK r'
        # (final devices [r'·Dc, (r'+1)·Dc) — a contiguous splitter range,
        # so each block's keys are ONE contiguous slice of the sorted
        # shard) along the Dr column peers {(*, c)}: Dr-1 waves.  The
        # arrivals (all destined to block r') are sorted into one run;
        # phase 2 slices it at the block's internal final splitters and
        # routes slice c' along the Dc row peers {(r', *)}: Dc-1 waves.
        d_r, d_c = hier
        r_me = me // d_c
        c_me = me % d_c
        col_sel = {
            i: (i // d_c, [g * d_c + (i % d_c) for g in range(d_r)])
            for i in range(n_dev)
        }
        row_sel = {
            i: (i % d_c, [(i // d_c) * d_c + g for g in range(d_c)])
            for i in range(n_dev)
        }
        slot1, slot2 = slot  # phase slot sizes (pow2)

        # phase 1: block boundaries = every Dc-th splitter
        bounds1, counts1 = split_bounds(
            s_key, m_valid, [splitters[b * d_c - 1] for b in range(1, d_r)]
        )
        send1 = _pack_slots(planes, bounds1, counts1, d_r, slot1, num_cmp)
        merged1, valid1 = _group_exchange(
            send1, counts1, axis, r_me, d_r, col_sel, num_cmp
        )

        # phase 2: slice my block's sorted run at its internal final
        # splitters (block index = my ROW coordinate r_me after phase 1)
        my_block_splits = [
            jax.lax.dynamic_index_in_dim(
                splitters, r_me * d_c + j, keepdims=False
            )
            for j in range(d_c - 1)
        ]
        bounds2, counts2 = split_bounds(merged1[0], valid1, my_block_splits)
        send2 = _pack_slots(merged1, bounds2, counts2, d_c, slot2, num_cmp)
        merged, valid = _group_exchange(
            send2, counts2, axis, c_me, d_c, row_sel, num_cmp
        )
        ovf = jnp.maximum(jnp.max(counts1 - slot1), jnp.max(counts2 - slot2))
        overflow = jax.lax.pmax(ovf, axis) > 0

    return (*merged, valid.reshape(1), overflow.reshape(1))


def _hier_factor(n_dev: int) -> tuple[int, int] | None:
    """Near-square pow2 factorization Dr x Dc of a pow2 device count
    (None when D is not a pow2 >= 4 — hier falls back to flat)."""
    if n_dev < 4 or n_dev & (n_dev - 1):
        return None
    k = n_dev.bit_length() - 1
    return 1 << (k - k // 2), 1 << (k // 2)


def _run_sharded(keys, payloads, mesh, axis, capacity, with_index,
                 exchange="flat"):
    if keys.dtype != jnp.uint32:
        # int32 keys would silently compare wrong — reject like ops.sort.
        raise TypeError(f"keys must be uint32, got {keys.dtype}")
    for p in payloads:
        if p.shape != keys.shape or p.dtype.itemsize != 4:
            raise TypeError(
                f"payloads must be 32-bit arrays of shape {keys.shape}"
            )
    if exchange not in ("flat", "hier"):
        raise ValueError(f"exchange must be 'flat' or 'hier', got {exchange!r}")
    n_dev = mesh.shape[axis]
    n = keys.shape[0]
    # ragged n: pad to D·ceil(n/D) with the maximum key at the global tail;
    # the shard body derives its valid prefix from n and never lets pads
    # into the exchange.
    m = cdiv(n, n_dev)
    padded_n = m * n_dev
    if padded_n != n:
        keys = jnp.concatenate(
            [keys, jnp.full((padded_n - n,), 0xFFFFFFFF, jnp.uint32)]
        )
        payloads = tuple(
            jnp.concatenate([p, jnp.zeros((padded_n - n,), p.dtype)])
            for p in payloads
        )
    hier = _hier_factor(n_dev) if exchange == "hier" else None
    if hier is not None:
        d_r, d_c = hier
        slot = (
            _pow2_pad(capacity * cdiv(m, d_r), min_total=SLOT_ALIGN),
            _pow2_pad(capacity * cdiv(m, d_c), min_total=SLOT_ALIGN),
        )
    else:
        slot = _pow2_pad(capacity * cdiv(n, n_dev * n_dev), min_total=SLOT_ALIGN)

    # Payload sorts order by (key, global index): stable across the mesh,
    # and a real 0xFFFFFFFF key always sorts ahead of the slot padding, so
    # the valid prefix keeps its payloads.
    num_cmp = 2 if (with_index or payloads) else 1
    body = functools.partial(
        _shard_body, n_dev=n_dev, slot=slot, n=n, axis=axis,
        num_cmp=num_cmp, hier=hier,
    )
    n_out = 1 + len(payloads) + (num_cmp - 1)
    fn = shard_map(
        lambda k, *ps: body(k, ps),
        mesh=mesh,
        in_specs=(P(axis),) * (1 + len(payloads)),
        out_specs=(P(axis),) * (n_out + 2),
    )
    *planes, valid, overflow = fn(keys, *payloads)
    planes = [p.reshape(n_dev, -1) for p in planes]
    return planes, valid.reshape(-1), overflow.reshape(-1)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "capacity", "exchange")
)
def sort_sharded(
    keys,
    mesh: Mesh,
    axis: str = "d",
    capacity: int = 4,
    exchange: str = "flat",
):
    """Distributed sort of uint32 keys sharded over `axis` of `mesh`.

    Returns (sorted_padded, valid, overflow):
      sorted_padded — (D, L) uint32, row d = device d's sorted shard,
        padded past `valid[d]`;
      valid — (D,) int32 count of real keys per device;
      overflow — (D,) bool, True anywhere means slot capacity was exceeded
        and the result must not be trusted (re-run with higher capacity).
    The concatenation of row 0's valid prefix, row 1's, ... is the globally
    sorted sequence.
    """
    planes, valid, overflow = _run_sharded(
        keys, (), mesh, axis, capacity, False, exchange
    )
    return planes[0], valid, overflow


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "capacity", "exchange")
)
def sort_pairs_sharded(
    keys,
    values,
    mesh: Mesh,
    axis: str = "d",
    capacity: int = 4,
    exchange: str = "flat",
):
    """Distributed stable key+payload sort. values: any 32-bit dtype, same
    shape; equal keys keep their original relative order across the whole
    mesh.

    Returns (sorted_keys, sorted_values, valid, overflow) with the same
    row/prefix semantics as sort_sharded.
    """
    planes, valid, overflow = _run_sharded(
        keys, (values,), mesh, axis, capacity, True, exchange
    )
    return planes[0], planes[-1], valid, overflow


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "capacity"))
def argsort_sharded(
    keys,
    mesh: Mesh,
    axis: str = "d",
    capacity: int = 4,
):
    """Distributed stable argsort: returns (sorted_keys, global_indices,
    valid, overflow).  global_indices[d, i] is the original flat position
    of sorted_padded[d, i]."""
    planes, valid, overflow = _run_sharded(
        keys, (), mesh, axis, capacity, True
    )
    return planes[0], planes[1], valid, overflow


def _escalate(step, start_capacity, max_capacity):
    """Run step(capacity) with capacity doubling until nothing overflows."""
    c = start_capacity
    while True:
        *out, overflow = step(c)
        if not bool(np.any(np.asarray(jax.device_get(overflow)))):
            return (*out, c)
        if c >= max_capacity:
            raise RuntimeError(
                f"dist_sort slot overflow persists at capacity={c}"
            )
        c *= 2


def sort_sharded_auto(
    keys,
    mesh: Mesh,
    axis: str = "d",
    exchange: str = "flat",
    start_capacity: int = 2,
    max_capacity: int = 64,
):
    """Memory-tight distributed sort with automatic capacity escalation.

    sort_sharded's recv slots are static shapes (capacity × ceil(N/D²),
    pow2-rounded — XLA cannot size buffers from data), so the skew-safe
    default capacity=4 makes the recv buffer ≈4–8× the shard.  This wrapper
    starts at capacity=2 — the mean per-(src,dst) count plus 2× headroom
    for sampling noise; capacity=1 would sit exactly AT the uniform mean
    and overflow on fluctuation — so recv ≈2–4× the shard.  It reads the
    overflow flag — one host sync — and doubles capacity only when the
    data's (src,dst) skew actually demands it: the deterministic-relaunch
    idiom of utils/guard.py applied to slot overflow (sorting is
    stateless, so a relaunch at higher capacity is exact, not
    best-effort).  Worst case (globally presorted input: every source
    shard lands on one destination) escalates to capacity ≈ D.

    Returns (sorted_padded, valid, capacity_used).  Raises RuntimeError if
    max_capacity still overflows.
    """
    return _escalate(
        lambda c: sort_sharded(
            keys, mesh, axis=axis, capacity=c, exchange=exchange
        ),
        start_capacity, max_capacity,
    )


def sort_pairs_sharded_auto(
    keys,
    values,
    mesh: Mesh,
    axis: str = "d",
    exchange: str = "flat",
    start_capacity: int = 2,
    max_capacity: int = 64,
):
    """sort_sharded_auto for key+payload shards: same memory-tight
    capacity-escalation contract (see sort_sharded_auto), returning
    (sorted_keys, sorted_values, valid, capacity_used)."""
    return _escalate(
        lambda c: sort_pairs_sharded(
            keys, values, mesh, axis=axis, capacity=c, exchange=exchange
        ),
        start_capacity, max_capacity,
    )


def collect(sorted_padded, valid):
    """Host-side: concatenate valid prefixes into one sorted numpy array."""
    rows = np.asarray(jax.device_get(sorted_padded))
    counts = np.asarray(jax.device_get(valid))
    return np.concatenate([rows[d, : counts[d]] for d in range(rows.shape[0])])
