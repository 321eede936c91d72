"""Attention-LM serving path — the port of ``repro/serving/attention.py``:
a paged KV cache and batched attention kernels on the region fabric.

The second LM backend behind the serving engine (``lm="attention"``).  One
transformer-style step — embedding + positional lookup, QKV projections,
GQA attention over a **paged KV cache**, output projection, greedy readout
— runs as two region bitstreams:

- ``AttnPrefill``: batched prefill.  Up to ``prefill_batch`` sequences
  share one task; the prompt is folded one ``block_size``-wide segment per
  budget unit through the hand-written flash-attention kernel
  (``kernels/flash_attention``, ``csrc/flash_attention.cu``) with a runtime
  ``q_offset``, writing each row's K/V as it goes and emitting each row's
  first token.
- ``AttnDecode``: batched multi-slot decode.  One kernel launch per step
  advances every active slot one token against its own block table through
  the hand-written paged decode kernel (``kernels/decode_attention``,
  ``csrc/decode_attention.cu``), which walks the table itself.

On the chunk path the projections and the readout are plain matrix
products outside any kernel, as in the reference (there they are XLA's);
they stay ``torch.matmul`` in f32 with TF32 off.  Loop control is on the
host: the segment start ``c * C`` is a host int, so the reference's
``dynamic_slice``/``dynamic_update_slice`` become slice writes into
``k_new``/``v_new``, and ``q_offset`` enters the kernel as an int argument.
The buffers are the region's private copies, so each step writes its slot
of them in place.

Both kernels register a persistent entry (``mega``): in megakernel mode a
task's chunk loop is one cooperative launch of M4 (``AttnPrefill``) or M5
(``AttnDecode``) on the card (``csrc/attn_lm.cu``, ``kernels/attn_lm``),
with the context on the device, B2's or B3's device code, and the
projections and readout as f32 products inside the launch.  It computes
``o @ Wo`` and the readout for the rows whose token is kept only (M4: the
rows that emit in a segment; M5: the live rows), the tokens the chunk body
keeps from its logits of every row.

KV pages live in two ``[NB, block_size, kv_heads, head_dim]`` device pools
threaded round to round (``device_result=True``); the host-side page
accounting is ``core.context.KVBlockPool``.  Block 0 is the reserved null
page: tables are padded with it and inactive rows scatter zeros there.
The engine writes prefilled K/V into the pools in place on its own stream,
after the producing round's event (``core/streams.py``).

The weights — one flat f32 ``[rows, d_model]`` buffer, 2.66 GB at Qwen3-8B's
attention widths — are built on the host with bytes identical to the
reference's, uploaded to the card **once** by ``AttentionLM``, and every
bundle passes that tensor; each task's region still makes its own
device-to-device copy in ``_upload``.

Determinism contract, as in the reference: every buffer shape is fixed by
the config, and rows are independent, so ``attention_oracle_stream`` can
replay one sequence alone through the same kernels and shapes and demand
token equality with any engine schedule.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.controller.kernels import _REGISTRY, ctrl_kernel, get_kernel
from repro_torch.core.context import ContextRecord, KVBlockPool
from repro_torch.core.preemption import for_save, make_pipelined_chunk
from repro_torch.core.streams import record_ready, to_host, wait_ready
from repro_torch.kernels.attn_lm.kernel import Geometry
from repro_torch.kernels.attn_lm.ops import attn_decode_mega, attn_prefill_mega
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.serving.kernels import (COL_ACTIVE, COL_LAST_TOK, COL_N_EMIT,
                                         SLOT_POS)

# slot-table layout (AttnDecode bufs[3], i32[S, TABLE_META + blocks/seq]):
# the surrogate's three columns, plus the per-slot write position, then
# the block table itself — page ids in position order, 0-padded (null)
COL_SEQ_LEN = 3
TABLE_META = 4

PREFILL_OUT_W = 8   # first token lands in out[row, 0]
META_W = 8          # AttnPrefill per-row metadata width (col 0 = prompt_len)

# rows of the weights drawn, or uploaded, per step: bounds the float64
# temporary of the draw (and the host staging of the upload) to 268 MB at
# d_model = 4096
_WEIGHT_ROWS_PER_STEP = 8192


@dataclass(frozen=True)
class AttentionParams:
    """Model + paging geometry.  Frozen and hashable: the weight builder
    and kernel registry key off the whole record."""
    d_model: int = 64
    vocab: int = 101
    n_heads: int = 4
    kv_heads: int = 2
    head_dim: int = 16
    block_size: int = 8      # KV page size, in token positions
    max_ctx: int = 64        # prompt + generated positions per sequence
    seed: int = 7            # weight init seed

    def __post_init__(self):
        if self.n_heads % self.kv_heads:
            raise ValueError(f"n_heads={self.n_heads} must be a multiple "
                             f"of kv_heads={self.kv_heads}")
        if self.max_ctx % self.block_size:
            raise ValueError(f"max_ctx={self.max_ctx} must be a multiple "
                             f"of block_size={self.block_size}")
        if self.max_ctx > 128:
            # the reference's cap (its flash key tile is min(128, S)); the
            # port keeps it so every geometry is one the reference runs
            raise ValueError(f"max_ctx={self.max_ctx} > 128 unsupported")
        for name in ("d_model", "vocab", "n_heads", "kv_heads", "head_dim",
                     "block_size", "max_ctx"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @property
    def blocks_per_seq(self) -> int:
        return self.max_ctx // self.block_size

    @property
    def table_width(self) -> int:
        return TABLE_META + self.blocks_per_seq

    def geometry(self) -> Geometry:
        """The model and paging geometry as M4/M5's wrappers take it."""
        return Geometry(self.d_model, self.vocab, self.n_heads,
                        self.kv_heads, self.head_dim, self.block_size,
                        self.max_ctx)


# -- weights -------------------------------------------------------------
# One flat f32[rows, d_model] buffer shared by both kernels and the
# oracle, stored as rows of width d_model:
#   [E | pos_emb | Wq^T | Wk^T | Wv^T | Wo]

def _row_offsets(p: AttentionParams) -> Tuple[int, ...]:
    q = p.n_heads * p.head_dim
    kv = p.kv_heads * p.head_dim
    e0 = 0
    pe0 = p.vocab
    q0 = pe0 + p.max_ctx
    k0 = q0 + q
    v0 = k0 + kv
    o0 = v0 + kv
    return e0, pe0, q0, k0, v0, o0, o0 + q


@functools.lru_cache(maxsize=2)
def build_weights(p: AttentionParams) -> np.ndarray:
    """Deterministic seeded weights, f32[rows, d_model], byte-identical to
    the reference's ``build_weights``.  The normals are drawn in row
    chunks: numpy's ``Generator`` continues one stream across calls, so the
    values are the same as one whole draw, without its float64 temporary.
    Cached per params — callers must treat the array as read-only."""
    e0, pe0, q0, k0, v0, o0, rows = _row_offsets(p)
    rng = np.random.default_rng(p.seed)
    w = np.empty((rows, p.d_model), np.float32)
    for r0 in range(0, rows, _WEIGHT_ROWS_PER_STEP):
        r1 = min(rows, r0 + _WEIGHT_ROWS_PER_STEP)
        w[r0:r1] = rng.standard_normal((r1 - r0, p.d_model))
    w[pe0:q0] *= 0.5                       # positional table, kept small
    w[q0:] *= 1.0 / np.sqrt(p.d_model)     # projections
    w.setflags(write=False)
    return w


def load_weights(w: np.ndarray, device) -> torch.Tensor:
    """The reference's parameters (numpy f32 ``[rows, d_model]``) as the
    port's weights tensor on ``device``, copied in row chunks and marked
    ready for other streams."""
    device = torch.device(device)
    out = torch.empty(w.shape, dtype=torch.float32, device=device)
    for r0 in range(0, w.shape[0], _WEIGHT_ROWS_PER_STEP):
        rows = np.array(w[r0:r0 + _WEIGHT_ROWS_PER_STEP], np.float32)
        out[r0:r0 + rows.shape[0]].copy_(torch.from_numpy(rows))
    record_ready([out], device)
    return out


def _split(w, p: AttentionParams):
    """(E, pos_emb, WqT, WkT, WvT, Wo) views of the flat buffer."""
    e0, pe0, q0, k0, v0, o0, rows = _row_offsets(p)
    return w[e0:pe0], w[pe0:q0], w[q0:k0], w[k0:v0], w[v0:o0], w[o0:rows]


# -- kernel bodies -------------------------------------------------------

def _make_prefill_fn(p: AttentionParams):
    H, KV, hd, C = p.n_heads, p.kv_heads, p.head_dim, p.block_size

    def attn_prefill(ctx: ContextRecord, bufs, ints, floats):
        """Fold each row's prompt one C-wide segment per budget unit.
        bufs: (out i32[PB, 8], k_new f32[PB, P, KV, hd], v_new ditto,
        prompt i32[PB, P], meta i32[PB, 8] with prompt_len in col 0,
        weights f32[rows, D]).  P == max_ctx always, so every prefill
        shares one bitstream and one numeric schedule."""
        out, k_new, v_new, prompt, meta, weights = bufs[:6]
        PB, P = prompt.shape
        n_seg = P // C
        plen = meta[:, 0]
        E, pe, wq, wk, wv, wo = _split(weights, p)

        def body_c(ctx, c, st):
            start = c * C
            toks = prompt[:, start:start + C]
            pos = torch.arange(start, start + C, device=prompt.device)
            valid = pos[None, :] < plen[:, None]
            x = E[toks] + pe[pos][None, :, :]
            x = torch.where(valid[..., None], x, 0.0)     # [PB, C, D]
            q = (x @ wq.T).reshape(PB, C, H, hd).transpose(1, 2)
            k_new[:, start:start + C] = (x @ wk.T).reshape(PB, C, KV, hd)
            v_new[:, start:start + C] = (x @ wv.T).reshape(PB, C, KV, hd)
            # causal flash over the cache filled so far: positions past
            # ``start + C`` are still zero, and the causal mask from the
            # runtime q_offset keeps them out of every valid query row
            o = flash_attention(q, k_new.transpose(1, 2),
                                v_new.transpose(1, 2), causal=True,
                                q_offset=start)
            # no residual into the readout (the reference's rationale:
            # y @ E.T would be self-dominated and re-emit the last token)
            o = o.transpose(1, 2).reshape(PB, C, H * hd)
            logits = (o @ wo) @ E.T                       # [PB, C, vocab]
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            # a row emits its first token at prompt position plen-1
            emit = valid & (pos[None, :] == plen[:, None] - 1)
            picked = torch.where(emit, nxt, 0).sum(dim=1, dtype=torch.int32)
            out[:, 0] = torch.where(emit.any(dim=1), picked, out[:, 0])
            return ctx.checkpoint(SLOT_POS, c + 1), st

        ctx, _ = for_save(ctx, SLOT_POS, 0, n_seg, 1, body_c, None)
        if ctx.intr == 0:
            ctx = ctx.finish()
        return ctx, (out, k_new, v_new, prompt, meta, weights)

    return attn_prefill


def _make_decode_fn(p: AttentionParams):
    H, KV, hd, BS = p.n_heads, p.kv_heads, p.head_dim, p.block_size
    T_blk = p.blocks_per_seq

    def attn_decode(ctx: ContextRecord, bufs, ints, floats):
        """One decode round: every active slot advances one token per
        step, R steps, against its block table.  bufs: (out i32[S, R],
        k_pool f32[NB, BS, KV, hd], v_pool ditto, table
        i32[S, TABLE_META + T_blk], weights f32[rows, D])."""
        out, k_pool, v_pool, table, weights = bufs[:5]
        S, R = out.shape
        E, pe, wq, wk, wv, wo = _split(weights, p)
        rows = torch.arange(S, device=table.device)

        def body_t(ctx, t, st):
            live = (table[:, COL_ACTIVE] == 1) & (t < table[:, COL_N_EMIT])
            pos = table[:, COL_SEQ_LEN].clone()
            posc = pos.clamp(0, p.max_ctx - 1)
            x = E[table[:, COL_LAST_TOK]] + pe[posc]
            x = torch.where(live[:, None], x, 0.0)        # [S, D]
            q = (x @ wq.T).reshape(S, H, 1, hd)
            k = (x @ wk.T).reshape(S, KV, hd)
            v = (x @ wv.T).reshape(S, KV, hd)
            # scatter this step's K/V into each row's current page; dead
            # rows write zeros to the null page (same-value duplicates,
            # so their order can never matter)
            blk = table[rows, (TABLE_META + posc // BS).long()]
            bid = torch.where(live, blk, 0).long()
            off = torch.where(live, posc % BS, 0).long()
            k_pool.index_put_((bid, off), torch.where(live[:, None, None], k,
                                                      0.0))
            v_pool.index_put_((bid, off), torch.where(live[:, None, None], v,
                                                      0.0))
            tbl = table[:, TABLE_META:TABLE_META + T_blk]
            o = paged_decode_attention(q, k_pool, v_pool, tbl,
                                       torch.where(live, posc + 1, 0))
            # readout without the residual (same rationale as prefill)
            logits = (o.reshape(S, H * hd) @ wo) @ E.T    # [S, vocab]
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            out[:, t] = torch.where(live, nxt, out[:, t])
            table[:, COL_LAST_TOK] = torch.where(live, nxt,
                                                 table[:, COL_LAST_TOK])
            table[:, COL_SEQ_LEN] = torch.where(live, pos + 1, pos)
            return ctx.checkpoint(SLOT_POS, t + 1), st

        ctx, _ = for_save(ctx, SLOT_POS, 0, R, 1, body_t, None)
        if ctx.intr == 0:
            ctx = ctx.finish()
        return ctx, (out, k_pool, v_pool, table, weights) + tuple(bufs[5:])

    return attn_decode


def _params_tag(p: AttentionParams) -> str:
    if p == AttentionParams():
        return ""
    return (f"@d{p.d_model}v{p.vocab}h{p.n_heads}kv{p.kv_heads}"
            f"hd{p.head_dim}b{p.block_size}c{p.max_ctx}s{p.seed}")


def _persistent(name: str, p: AttentionParams, decode: bool):
    """The megakernel engine's entry for ``name``: M5 (``decode``) or M4,
    at ``p``'s geometry as ints."""
    g = p.geometry()
    launch = attn_decode_mega if decode else attn_prefill_mega

    def entry(ctx_words, bufs, ints, floats, budget, flag):
        return launch(name, ctx_words, bufs, g, budget, flag)

    return entry


def register_attention_kernels(
        p: Optional[AttentionParams] = None) -> Tuple[str, str]:
    """Register (idempotently) the prefill/decode bitstreams for ``p``
    and return their kernel names — the reference's names, so bitstream
    keys compare across the two packages."""
    p = p or AttentionParams()
    tag = _params_tag(p)
    names = (f"AttnPrefill{tag}", f"AttnDecode{tag}")
    if names[0] not in _REGISTRY:
        ctrl_kernel(names[0], backend="PYNQ",
                    ktile_args=("out", "k_new", "v_new", "prompt", "meta",
                                "weights"),
                    int_args=("PB", "P", "vocab"),
                    default_budget=4, device_result=True,
                    library="flash_attention",
                    mega=_persistent(names[0], p, decode=False),
                    mega_library="attn_lm")(_make_prefill_fn(p))
        ctrl_kernel(names[1], backend="PYNQ",
                    ktile_args=("out", "k_pool", "v_pool", "table",
                                "weights"),
                    int_args=("S", "R", "vocab"),
                    default_budget=4, device_result=True,
                    library="decode_attention",
                    mega=_persistent(names[1], p, decode=True),
                    mega_library="attn_lm")(_make_decode_fn(p))
    return names


# the default geometry registers at import time, exactly like the
# surrogate kernels (controller.kernels._register_builtin imports us)
register_attention_kernels()


# -- serving backend -----------------------------------------------------

class AttentionLM:
    """The engine-facing LM backend for ``ServingConfig(lm="attention")``.

    Owns the paged-KV machinery: the ``KVBlockPool`` accounting, the
    device-resident weights and K/V pools threaded round to round, the
    per-sequence write positions, and the construction of prefill/decode
    ArgBundles.  The ``ServingEngine`` stays LM-agnostic.
    """

    name = "attention"

    def __init__(self, cfg, device, metrics=None):
        p = AttentionParams(
            d_model=cfg.d_model, vocab=cfg.vocab_size,
            n_heads=cfg.attn_heads, kv_heads=cfg.attn_kv_heads,
            head_dim=cfg.attn_head_dim, block_size=cfg.kv_block_size,
            max_ctx=cfg.max_ctx, seed=cfg.weights_seed)
        self.params = p
        self.cfg = cfg
        self.device = torch.device(device)
        self.prefill_name, self.decode_name = register_attention_kernels(p)
        self.weights = load_weights(build_weights(p), self.device)
        # default pool: enough pages for every slot to hold a full
        # context, so admission can never deadlock (+1 for the null page)
        n_blocks = cfg.kv_blocks or (
            cfg.max_slots * p.blocks_per_seq + 1)
        self.pool = KVBlockPool(n_blocks, p.block_size, metrics=metrics)
        shape = (n_blocks, p.block_size, p.kv_heads, p.head_dim)
        self.k_pool = torch.zeros(shape, dtype=torch.float32,
                                  device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        record_ready([self.k_pool, self.v_pool], self.device)
        self._kv_pending: Dict[int, tuple] = {}  # sid -> (k rows, v rows)
        self._pos: Dict[int, int] = {}           # sid -> next write position
        self._round: Optional[tuple] = None      # (occupied, n_emit)

    @property
    def prefill_batch(self) -> int:
        return max(1, int(getattr(self.cfg, "prefill_batch", 1) or 1))

    def _kv_need(self, seq) -> int:
        """Total KV positions the sequence will ever write: the prompt
        plus one per generated token after the first (the first token's
        K/V lands at position prompt_len on its first decode step)."""
        return len(seq.prompt) + seq.params.max_new_tokens - 1

    # -- admission -------------------------------------------------------
    def reject(self, seq) -> Optional[str]:
        if not seq.prompt:
            return "attention LM needs a non-empty prompt"
        need = self._kv_need(seq)
        if need > self.params.max_ctx:
            return (f"sequence needs {need} KV positions "
                    f"(prompt {len(seq.prompt)} + "
                    f"{seq.params.max_new_tokens - 1} decode writes) "
                    f"> max_ctx={self.params.max_ctx}")
        return None

    def can_admit(self, seq) -> bool:
        """Reserve every page the sequence will ever need (all-or-nothing
        through ``pool.ensure``); a refusal counts ``alloc_deferred`` and
        the engine holds the sequence until evictions free pages."""
        return self.pool.ensure(seq.sid, self._kv_need(seq)) is not None

    # -- prefill ---------------------------------------------------------
    def prefill_bundle(self, seqs) -> Tuple[str, object]:
        p = self.params
        PB, P = self.prefill_batch, p.max_ctx
        prompt = np.zeros((PB, P), np.int32)
        meta = np.zeros((PB, META_W), np.int32)
        for r, seq in enumerate(seqs):
            prompt[r, :len(seq.prompt)] = seq.prompt
            meta[r, 0] = len(seq.prompt)
        out = np.zeros((PB, PREFILL_OUT_W), np.int32)
        kv = np.zeros((PB, P, p.kv_heads, p.head_dim), np.float32)
        kd = get_kernel(self.prefill_name)
        return self.prefill_name, kd.bundle(
            out, kv, kv.copy(), prompt, meta, self.weights,
            PB=PB, P=P, vocab=p.vocab)

    def harvest_prefill(self, seqs, bufs) -> List[int]:
        out = to_host(bufs[0])
        # the pool writes in decode_bundle run on this thread's stream
        kn, vn = wait_ready(bufs[1]), wait_ready(bufs[2])
        firsts = []
        for r, seq in enumerate(seqs):
            self._kv_pending[seq.sid] = (kn[r], vn[r])
            firsts.append(int(out[r, 0]))
        return firsts

    # -- decode ----------------------------------------------------------
    def decode_bundle(self, occupied, inserted, n_emit):
        p, cfg = self.params, self.cfg
        S, R, BS = cfg.max_slots, cfg.round_tokens, p.block_size
        table = np.zeros((S, p.table_width), np.int32)
        inserted_set = set(inserted)
        if inserted:
            # the pools are the last round's results: write them in place
            # (the reference builds new arrays) after that round's event
            wait_ready(self.k_pool)
            wait_ready(self.v_pool)
        for i, seq in occupied:
            sid = seq.sid
            if i in inserted_set:
                blocks = self.pool.ensure(sid, self._kv_need(seq))
                assert blocks is not None, "can_admit gated this insert"
                L = len(seq.prompt)
                self._pos[sid] = L
                kn, vn = self._kv_pending.pop(sid)
                npg = self.pool.blocks_for(L)
                ids = torch.as_tensor(blocks[:npg], dtype=torch.long,
                                      device=self.device)
                self.k_pool[ids] = kn[:npg * BS].reshape(
                    npg, BS, p.kv_heads, p.head_dim)
                self.v_pool[ids] = vn[:npg * BS].reshape(
                    npg, BS, p.kv_heads, p.head_dim)
            blocks = self.pool.blocks(sid)
            table[i, COL_ACTIVE] = 1
            table[i, COL_N_EMIT] = n_emit[i]
            table[i, COL_LAST_TOK] = seq.tokens[-1]
            table[i, COL_SEQ_LEN] = self._pos[sid]
            table[i, TABLE_META:TABLE_META + len(blocks)] = blocks
        if inserted:
            record_ready([self.k_pool, self.v_pool], self.device)
        out = np.zeros((S, R), np.int32)
        kd = get_kernel(self.decode_name)
        bundle = kd.bundle(out, self.k_pool, self.v_pool, table,
                           self.weights, S=S, R=R, vocab=p.vocab)
        self._round = (list(occupied), dict(n_emit))
        return self.decode_name, bundle, not inserted

    def finish_round(self, bufs) -> np.ndarray:
        self.k_pool, self.v_pool = bufs[1], bufs[2]
        occupied, n_emit = self._round
        self._round = None
        for i, seq in occupied:
            self._pos[seq.sid] = self._pos.get(seq.sid, 0) + n_emit[i]
        return to_host(bufs[0])

    def fail_round(self):
        # the engine fails every resident sequence after this; their
        # pages come back through drop() as each one settles
        self._round = None

    def drop(self, sid: int):
        self._kv_pending.pop(sid, None)
        self._pos.pop(sid, None)
        self.pool.release(sid)

    # -- observability ---------------------------------------------------
    def kv_stats(self) -> Optional[dict]:
        return self.pool.stats()

    def trace_attrs(self) -> dict:
        return {"kv": self.pool.in_use}


# -- standalone oracle ---------------------------------------------------

def _drive(name: str, bundle, budget: int, device: torch.device):
    """Run one task standalone through the same pipelined chunk entry the
    regions bind.  Host buffers are copied to ``device``; device tensors
    are used as they are (the bodies never write the weights, and the
    oracle owns its pools)."""
    chunk = make_pipelined_chunk(get_kernel(name).fn)
    bufs, ints, floats = bundle.padded()
    bufs = tuple(b if isinstance(b, torch.Tensor)
                 else torch.as_tensor(b).to(device, copy=True) for b in bufs)
    ctx = ContextRecord.fresh()
    while True:
        ctx, bufs, done = chunk(ctx, bufs, ints, floats, budget)
        if done:
            return bufs


def attention_oracle_stream(prompt, max_new_tokens: int,
                            p: Optional[AttentionParams] = None, *,
                            max_slots: int = 4, round_tokens: int = 4,
                            prefill_batch: int = 1,
                            kv_blocks: Optional[int] = None,
                            chunk_budget: int = 4,
                            weights: Optional[torch.Tensor] = None) -> list:
    """The exact token stream the serving engine must produce for one
    sequence, replayed standalone through the same kernels with the same
    buffer shapes: the sequence sits in row 0 of an otherwise empty
    prefill/decode batch and runs uninterrupted.  ``weights`` (default:
    ``build_weights(p)`` on the CPU) picks the device: pass the serving
    LM's tensor to replay on the card."""
    p = p or AttentionParams()
    pre_name, dec_name = register_attention_kernels(p)
    if weights is None:
        weights = load_weights(build_weights(p), "cpu")
    device = weights.device
    BS, T_blk = p.block_size, p.blocks_per_seq
    L = len(prompt)
    if not (0 < L and L + max_new_tokens - 1 <= p.max_ctx):
        raise ValueError(f"prompt {L} + {max_new_tokens - 1} decode writes "
                         f"must fit max_ctx={p.max_ctx}")

    # prefill: row 0 of a PB-row batch, everything else empty
    PB, P = max(1, prefill_batch), p.max_ctx
    prompt_buf = np.zeros((PB, P), np.int32)
    prompt_buf[0, :L] = prompt
    meta = np.zeros((PB, META_W), np.int32)
    meta[0, 0] = L
    kv = np.zeros((PB, P, p.kv_heads, p.head_dim), np.float32)
    kd = get_kernel(pre_name)
    bufs = _drive(pre_name, kd.bundle(
        np.zeros((PB, PREFILL_OUT_W), np.int32), kv, kv.copy(), prompt_buf,
        meta, weights, PB=PB, P=P, vocab=p.vocab), chunk_budget, device)
    toks = [int(to_host(bufs[0])[0, 0])]
    if max_new_tokens <= 1:
        return toks

    # paginate the prompt K/V into pool blocks 1..n (allocation order)
    n_blocks = kv_blocks or (max_slots * T_blk + 1)
    n_need = -(-(L + max_new_tokens - 1) // BS)
    blocks = list(range(1, n_need + 1))
    shape = (n_blocks, BS, p.kv_heads, p.head_dim)
    k_pool = torch.zeros(shape, dtype=torch.float32, device=device)
    v_pool = torch.zeros_like(k_pool)
    kn, vn = bufs[1][0], bufs[2][0]
    for j in range(-(-L // BS)):
        k_pool[blocks[j]] = kn[j * BS:(j + 1) * BS]
        v_pool[blocks[j]] = vn[j * BS:(j + 1) * BS]

    # decode rounds, slot 0 of an otherwise empty S-row table
    S, R = max_slots, round_tokens
    kdd = get_kernel(dec_name)
    pos = L
    while len(toks) < max_new_tokens:
        n = min(R, max_new_tokens - len(toks))
        table = np.zeros((S, p.table_width), np.int32)
        table[0, COL_ACTIVE] = 1
        table[0, COL_N_EMIT] = n
        table[0, COL_LAST_TOK] = toks[-1]
        table[0, COL_SEQ_LEN] = pos
        table[0, TABLE_META:TABLE_META + len(blocks)] = blocks
        bufs = _drive(dec_name, kdd.bundle(
            np.zeros((S, R), np.int32), k_pool, v_pool, table, weights,
            S=S, R=R, vocab=p.vocab), chunk_budget, device)
        toks.extend(int(t) for t in to_host(bufs[0])[0, :n])
        k_pool, v_pool = bufs[1], bufs[2]
        pos += n
    return toks
