"""Ring attention: exact attention over a sequence-sharded ``sp`` group.

The port of ``gpustack_tpu/ops/ring_attention.py`` (XLA ``shard_map`` with
``ppermute``, ``pmax`` and ``psum`` there; no Pallas kernel). A
sequence-parallel replica (``MeshPlan.sp > 1``) holds a prompt's tokens
and its KV cache in ``sp`` contiguous blocks, block ``i`` on the rank at
``sp`` index ``i`` (``SpecLayout.cache``), so no rank ever holds the whole
sequence's K/V.

- :func:`ring_attention` is a prefill from zero. Rank ``i`` holds its
  ``T_loc`` queries and keys; the K/V blocks travel one hop a step around
  the ``sp`` group (``Mesh.sp_p2p``: send to ``i + 1``, receive from
  ``i - 1``), double-buffered, so the next block's copy overlaps the
  current block's kernel. After ``j`` hops rank ``i`` holds block
  ``src = i - j``: one with ``src < i`` is wholly visible (the flash
  kernel's LSE mode at ``q_offset = (i - src) T_loc``), its own block is
  causal (``q_offset`` 0), and one with ``src > i`` (wrapped round the
  ring) is wholly masked and skipped, where JAX computes and discards it.
  Every rank still sends and receives every hop, so the group's
  point-to-point ops always pair up. The blocks' fp32 partial outputs are
  merged once, each weighed by ``exp(lse - max lse)``. Rank ``i`` runs
  ``i + 1`` blocks: the contiguous layout leaves rank ``sp - 1`` the most
  work (zigzag sharding would even it out).
- :func:`sp_cache_attention` is every other step against the resident
  cache (decode, a continuation chunk): the queries are whole on every
  ``sp`` rank, each rank scores its own cache segment (absolute position
  ``sp_rank * S_loc + j``) in plain fp32 torch, and the partial softmaxes
  merge exactly: an all-reduce MAX of the row maxima, then one SUM of
  ``l * c`` and ``acc * c`` over the group (JAX's ``pmax``/``psum``).

Layouts are the flash kernel's: q ``[B, T, Hq, d]``, k and v
``[B, S, Hkv, d]``, out ``[B, T, Hq * d]`` in q's dtype.
"""

from __future__ import annotations

import torch

from gpustack_tpu_torch.ops import flash_attention as fa

_NEG = -1e30
# fp32 scores of one query-row chunk of the cache merge's local part
CHUNK_BYTES = 1 << 30


def merge_partials(outs, lses) -> torch.Tensor:
    """Merge normalised partial attentions of the same rows over disjoint
    key blocks: ``outs`` ``[B, T, Hq * d]`` and ``lses`` ``[B, Hq, T]``
    fp32, one pair a block; returns the fp32 ``[B, T, Hq * d]`` of
    attention over all the blocks' keys. A row no block saw stays 0."""
    if len(outs) == 1:
        return outs[0]
    lse = torch.stack(lses)                                 # [n, B, Hq, T]
    m = lse.amax(dim=0)
    w = torch.exp(lse - m)
    w = w / w.sum(dim=0).clamp_min(1e-30)
    B, T, HD = outs[0].shape
    Hq = lse.shape[2]
    out = torch.zeros((B, T, Hq, HD // Hq), dtype=torch.float32,
                      device=outs[0].device)
    for o, wn in zip(outs, w):
        out.addcmul_(o.view(B, T, Hq, -1), wn.transpose(1, 2)[..., None])
    return out.reshape(B, T, HD)


def ring_attention(q, k, v, scale: float, mesh) -> torch.Tensor:
    """Causal GQA attention of a prefill from zero whose tokens are
    sequence-sharded over ``mesh``'s ``sp`` group: q ``[B, T_loc, Hq, d]``,
    k and v ``[B, T_loc, Hkv, d]``, this rank's block (absolute positions
    ``sp_rank * T_loc + t``). Returns this rank's ``[B, T_loc, Hq * d]``
    in q's dtype. On CUDA tensors each visible block is one launch of the
    flash kernel's LSE mode; on CPU ones, its plain version."""
    sp, i = mesh.sp, mesh.sp_rank
    T = q.shape[1]
    cur = torch.stack([k, v])               # one message a hop: [2, B, T, H, d]
    spare = torch.empty_like(cur) if sp > 1 else None
    outs, lses = [], []
    for j in range(sp):
        reqs = []
        if j + 1 < sp:
            reqs = mesh.sp_p2p([(cur, i + 1)], [(spare, i - 1)])
        src = i - j
        if src >= 0:                        # src < 0: wrapped, masked
            o, lse = fa.flash_attention_lse(q, cur[0], cur[1], scale,
                                            q_offset=(i - src) * T)
            outs.append(o)
            lses.append(lse)
        for r in reqs:
            r.wait()
        if j + 1 < sp:
            cur, spare = spare, cur
    return merge_partials(outs, lses).to(q.dtype)


def sp_cache_attention(q, k, v, positions, scale: float, mesh) -> torch.Tensor:
    """Attention of whole queries over a sequence-sharded cache: q
    ``[B, T, Hq, d]`` (the same on every ``sp`` rank), k and v
    ``[B, S_loc, Hkv, d]`` this rank's cache segment, ``positions``
    ``[B, T]`` the queries' absolute positions. Returns ``[B, T, Hq * d]``
    in q's dtype, the same on every ``sp`` rank."""
    B, T, Hq, d = q.shape
    S_loc, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, d)
    cache_pos = mesh.sp_rank * S_loc + torch.arange(S_loc, device=q.device)
    rows = max(1, CHUNK_BYTES // (B * Hq * S_loc * 4))
    ms, ls, accs = [], [], []
    for t in range(0, T, rows):
        mask = cache_pos[None, None, :] <= positions[:, t:t + rows, None]
        scores = torch.einsum(
            "bthgd,bshd->bhgts", qg[:, t:t + rows], k).float() * scale
        scores.masked_fill_(~mask[:, None, None], _NEG)
        m = scores.amax(dim=-1)                              # [B, Hkv, G, t]
        p = torch.where(scores <= _NEG / 2, 0.0,
                        torch.exp(scores - m[..., None]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgts,bshd->bhgtd", p, v.float()))
    m_loc, l_loc = torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)
    acc = torch.cat(accs, dim=-2)                           # [B,Hkv,G,T,d]
    m_all = mesh.all_reduce_sp(m_loc.clone(), op="max")
    c = torch.where(m_loc <= _NEG / 2, 0.0, torch.exp(m_loc - m_all))
    both = mesh.all_reduce_sp(
        torch.cat([(l_loc * c)[..., None], acc * c[..., None]], dim=-1))
    out = both[..., 1:] / both[..., :1].clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq * d).to(q.dtype)
