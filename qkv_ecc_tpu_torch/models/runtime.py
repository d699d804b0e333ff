"""Generation runtime over the paged ECC cache (counterpart of
``qkv_ecc_tpu/models/runtime.py``; gpt2 and the llama family in every mode:
int4 (read-time injection), int4-write-inject, int4-hamming,
int4-hamming84, int4-hamming84-interp and int12-golay, with or without
scrub, and with per-read ECC statistics; and the float arms fp16 and fp8).

Prefill writes whole pages with an indexed store and attends through the
codec round trip. Each decode step runs, per layer, the projections and RoPE,
the write chain, and the fused write+attend kernel
(kernels/paged_attention.py), which updates the caches in place:

  * scrubbed modes: the scrub-folded write and the extract read (K1); the
    parity columns of all layers land in one ``index_put_`` per K/V at the
    end of the step;
  * unscrubbed modes (interpolation, ``scrub=False``, and every step that
    collects ECC statistics): the raw-mask write of full rows and the
    correcting read (K2, K3), which streams parity and writes the data and
    parity columns itself;
  * mode ``int4``: a clean write and K1's general read, which flips the raw
    words it reads from a per-step seed (K2r);
  * fp16 / fp8: the raw values (bfloat16; e4m3, whose bytes fp8's write
    injection flips) and the float read (K2f), with scales of 1 passed as
    JAX passes them and never stored.

``init_generation_state`` allocates statically (sequence b owns pages
[b*P, (b+1)*P)); the serving layer (``serving/scheduler.py``) hands out
pages through ``cache/block_manager.py`` and decodes inactive slots, whose
block-table rows are -1, into the trash page 0.

A latent-attention model (deepseek_v2, models/deepseek_v2.py) caches one
``kv`` row a token and layer (its latent and roped key, one "head" of
``cfg.head_dim`` values) in mode int12-golay alone: prefill writes it and
attends in the non-absorbed form; a decode step absorbs q_nope . W_UK and
reads every context row once, for all heads, through the latent read
(kernels/paged_attention.py ``paged_latent_write_attend``). Its write masks
are one chain a step of [L, 1, B, 1, 1, codewords], one draw a layer in
prefill. Every other arm, a mesh, the server and training raise
NotImplementedError for it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..cache.layout import ECCCacheConfig, allocate_ecc_kv_cache
from ..device import resolve_device
from ..kernels import common as C
from ..kernels import swar
from ..kernels.grouped import grouped_mm
from ..kernels.paged_attention import paged_attention_ecc_write_attend, paged_latent_write_attend
from .config import ModelConfig, is_latent, refuse_latent
from .kv_policy import (
    N_BITS,
    KVCachePolicy,
    codeword_shape,
    decode_kv,
    encode_kv,
    encode_pack_kv_scrubbed,
    hoisted_logical_masks,
    hoisted_write_deltas,
    pack_kv,
    read_inject,
    write_inject,
)
from ..codecs.fault_injection import flip_mask
from ..parallel.mesh import all_gather_cat, all_reduce
from .. import tracing
from ..tracing import span
from .layers import causal_attention
from .registry import arch_module


def _use_scrub(policy: KVCachePolicy) -> bool:
    """Write-path scrubbing: persistent write-time injection, no
    interpolation (it needs the per-read doubles mask)."""
    return (
        policy.scrub
        and policy.codec in ("int4", "hamming74", "hamming84", "golay")
        and not policy.use_interpolation
        and policy.inject_at == "write"
    )


FUSED_CODECS = ("int4", "hamming74", "hamming84", "golay", "fp16", "fp8")


def check_latent_policy(cfg: ModelConfig, policy: KVCachePolicy):
    """A latent model runs mode int12-golay alone (Golay with write
    injection, no interpolation, scrubbed or with ECC counts)."""
    if is_latent(cfg) and (policy.codec != "golay" or policy.use_interpolation
                           or policy.inject_at != "write"):
        raise NotImplementedError(
            f"architecture '{cfg.arch}' ({cfg.name}) runs mode int12-golay alone, got codec "
            f"'{policy.codec}' (interpolation {policy.use_interpolation}, "
            f"injection at {policy.inject_at})")


def _check_slice(cfg: ModelConfig, policy: KVCachePolicy):
    """Raise for an architecture the port does not know and for a codec the
    runtime has no kernel for, as JAX's generate does."""
    arch_module(cfg)
    if policy.codec not in FUSED_CODECS:
        raise NotImplementedError(f"the runtime supports {FUSED_CODECS}, got '{policy.codec}'")
    check_latent_policy(cfg, policy)


def init_generation_state(cfg: ModelConfig, policy: KVCachePolicy, batch: int,
                          max_tokens: int, block_size: int = 128, device=None):
    """Allocate the paged cache and the static sequential block table on
    ``device`` (None: the card). Returns (state, block_table, cache_cfg)."""
    _check_slice(cfg, policy)
    device = resolve_device(device)
    pages_per_seq = -(-max_tokens // block_size)
    cache_cfg = ECCCacheConfig(
        num_blocks=batch * pages_per_seq,
        block_size=block_size,
        num_layers=cfg.num_layers,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        codec=policy.codec,
        max_seqs=batch,
        row_kinds=("kv",) if is_latent(cfg) else ("k", "v"),
    )
    state = allocate_ecc_kv_cache(cache_cfg, device=device)
    state["context_len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    block_table = torch.arange(batch * pages_per_seq, dtype=torch.int32,
                               device=device).reshape(batch, pages_per_seq)
    return state, block_table, cache_cfg


def _first_cache(state):
    """The first ``<kind>_cache`` array of the state (k_cache, or kv_cache)."""
    return state["k_cache"] if "k_cache" in state else state["kv_cache"]


def _check_block_size(state, block_size: int) -> int:
    """The cache's page size, which ``block_size`` must equal."""
    bs = _first_cache(state).shape[4]
    if block_size != bs:
        raise ValueError(f"block_size {block_size} != the cache's page size {bs}")
    return bs


def _physical_pages(block_table, positions, bs):
    """Physical page of each position [B, S]; raises on a page of -1 (an
    index_put_ would wrap it to the last page): a prompt is never written
    to an unallocated row."""
    phys = torch.gather(block_table.long(), 1, (positions // bs).long())
    if bool((phys < 0).any()):
        raise ValueError("write to a sequence with no page (block table entry -1)")
    return phys


def _trash_routed_slots(block_table, pos, bs):
    """(physical page, slot) [B] of each row's token at ``pos``, for the
    parity scatter of a decode step without a host sync. A row with a page
    keeps its own (page, slot) at any batch size. A row whose page is -1 (an
    inactive serving slot) goes to the trash page 0, where the kernels clamp
    its data column too, at slot r % block_size for the r-th such row: the
    first block_size of them get distinct slots, and any beyond share a
    trash slot, which no live row reads."""
    page = torch.gather(block_table.long(), 1, (pos // bs).long()[:, None])[:, 0]
    dead = page < 0
    rank = torch.cumsum(dead.long(), 0) - 1
    slots = torch.where(dead, rank % bs, (pos % bs).long())
    return page.clamp(min=0), slots


def _write_tokens(state, layer_idx, block_table, positions, kc, vc, ks, vs):
    """Store S packed tokens of every sequence: cache[layer, phys, h, :, slot]
    = rows[b, s, h, :]. kc/vc: [B, S, H, row_words] full rows, split here at
    the data/parity boundary, or the float codecs' values (e4m3 stored
    through its bytes); ks/vs: [B, S, H], or None (float codecs: no
    scales); positions: [B, S]."""
    bs = state["k_cache"].shape[4]
    phys = _physical_pages(block_table, positions, bs)
    slots = (positions % bs).long()
    for kind, rows, scales in (("k", kc, ks), ("v", vc, vs)):
        _write_rows(state, kind, layer_idx, phys, slots, rows, scales)
    return state


def _write_rows(state, kind, layer_idx, phys, slots, rows, scales):
    """Store the rows of one kind (state's <kind>_cache, <kind>_parity,
    <kind>_scales) at physical pages ``phys`` and ``slots`` [B, S]."""
    cache = state[f"{kind}_cache"]
    dw = cache.shape[3]
    C.fp8_as_bytes(cache)[layer_idx][phys, :, :, slots] = C.fp8_as_bytes(rows[..., :dw])
    if f"{kind}_parity" in state:
        state[f"{kind}_parity"][layer_idx][phys, :, :, slots] = rows[..., dw:]
    if scales is not None:
        state[f"{kind}_scales"][layer_idx][phys, :, slots] = scales


def sample_tokens(logits, temperature, generator, *, row_offset: int = 0, full_batch=None):
    """Next tokens [B] of logits [B, V]: rows at temperature 0 take the
    argmax, the others the Gumbel-max of logits / temperature (a draw from
    their softmax, as jax.random.categorical), uniforms from ``generator``
    on its device. temperature: a float, or [B] per row. With
    ``full_batch``, logits are rows [row_offset, row_offset + B) of a batch
    of that many, and the uniforms those rows of the whole batch's draw
    (a data-parallel rank's share of the single-device sample)."""
    t = torch.as_tensor(temperature, dtype=torch.float32).to(logits.device).expand(logits.shape[0])
    B, V = logits.shape
    u = torch.rand((full_batch or B, V), generator=generator,
                   device=logits.device)[row_offset:row_offset + B]
    sampled = torch.argmax(logits / t.clamp(min=1e-6)[:, None] - torch.log(-torch.log(u)), dim=-1)
    return torch.where(t > 0, sampled, torch.argmax(logits, dim=-1))


def _local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """cfg with a model rank's heads: num_heads / tp queries over
    num_kv_heads / tp KV heads (AssertionError when they do not divide, as
    JAX's assert); cfg itself at tp 1."""
    if tp == 1:
        return cfg
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise AssertionError(f"heads {cfg.num_heads}/{cfg.num_kv_heads} not divisible by tp={tp}")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def _rank_slice(masks, mesh, batch_dim: int, b_local: int, kv_local: int,
                batch_split: bool = True):
    """A rank's (data rows, KV heads) slice of masks drawn at the
    single-device shape: rows on ``batch_dim`` (all of them when the rows
    are not split over the data ranks), heads on ``batch_dim + 2``; the
    masks themselves without a mesh."""
    if mesh is None:
        return masks
    m = masks.narrow(batch_dim, mesh.data_index * b_local, b_local) if batch_split else masks
    return m.narrow(batch_dim + 2, mesh.model_index * kv_local, kv_local)


def _psum(t: torch.Tensor, group) -> torch.Tensor:
    """The model group's sum of a row-parallel product's partials, added in
    float32 and rounded once to t's dtype."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return all_reduce(t.float(), group).to(t.dtype)
    return all_reduce(t, group)


def _mesh_parts(cfg: ModelConfig, mesh, batch_split: bool = True):
    """(tp, dp, the rank's cfg, the row-parallel sum or None) of ``mesh``;
    (1, 1, cfg, None) without one. dp is 1 when the rows are not split."""
    if mesh is None:
        return 1, 1, cfg, None
    group = mesh.model_group
    reduce = None if group is None else (lambda t: _psum(t, group))
    return mesh.model, mesh.data if batch_split else 1, _local_cfg(cfg, mesh.model), reduce


def _lm_head(params, x, cfg: ModelConfig, mesh):
    """The logits over the whole vocabulary: an untied llama head on a mesh
    is vocab-sharded, its slices gathered over the model group."""
    logits = arch_module(cfg).lm_head(params, x, cfg)
    if mesh is not None and cfg.arch != "gpt2" and not cfg.tie_word_embeddings:
        logits = all_gather_cat(logits, mesh.model_group)
    return logits


@torch.no_grad()
def prefill(params, input_ids, state, block_table, cfg: ModelConfig,
            policy: KVCachePolicy, generator=None, logit_pos=None, true_len=None, *,
            read_masks=None, mesh=None, batch_split: bool = True):
    """Process the prompt [B, S]: write the cache and return the last
    token's logits [B, V] float32 (with ``logit_pos`` [B], those at each
    row's position; ``true_len`` [B] is stored as the context length: a
    bucket-padded prompt's pad tail is written but never attended, and
    decode overwrites it). Attention reads the codec round trip of
    what was written. With write injection on, masks come from
    ``generator``. Scrubbed modes store scrubbed codewords; the others store
    the raw ones and attend through the decode (with interpolation along the
    sequence when asked; golay keeps an uncorrectable codeword's data here).
    Mode ``int4`` stores clean nibbles and attends through fresh read flips:
    ``read_masks`` [L, 2, B, S, Hkv, D'] (the flips JAX draws from each
    layer's key folded with "READ"), or drawn from ``generator``.

    ``mesh``: this rank's (data, model) mesh (parallel/mesh.py). params are
    then its shards (parallel/sharding.shard_params), input_ids its rows
    and the cache its KV heads; every mask is drawn (or given) at the
    single-device run's shape, the whole batch's and all heads', and the
    rank keeps its slice, and the row-parallel products are summed over the
    model group. With ``batch_split`` False every data index prefills the
    same rows (the TP server's admission), whose masks are the single-device
    draw of those rows.

    Positional arguments are JAX's, a ``torch.Generator`` in place of
    ``step_key``; the others are the port's own, keyword-only."""
    _check_slice(cfg, policy)
    if is_latent(cfg):
        if mesh is not None:
            refuse_latent(cfg, "a mesh (parallel/)")
        return _prefill_latent(params, input_ids, state, block_table, cfg, policy, generator,
                               logit_pos, true_len)
    tp, dp, cfgl, reduce = _mesh_parts(cfg, mesh, batch_split)
    scrub = _use_scrub(policy)
    read = read_inject(policy)
    winject = write_inject(policy)
    B, S = input_ids.shape
    device = input_ids.device
    positions = torch.arange(S, device=device).expand(B, S)
    arch = arch_module(cfg)

    def draw(shape, n_bits):
        """The rank's slice of a draw at the single-device shape."""
        if generator is None:
            raise ValueError("fault injection needs masks or a torch.Generator")
        full = flip_mask((shape[0] * dp, shape[1], shape[2] * tp) + tuple(shape[3:]),
                         policy.ber, n_bits, generator)
        return _rank_slice(full, mesh, 0, shape[0], shape[2], batch_split)

    with span("prefill.embed"):
        inv_freq = arch.inv_freq(cfg, device)
        x = arch.embed(params, input_ids, cfg, positions)
    for i, lp in enumerate(params["layers"]):
        with span("prefill.qkv"):
            q, k, v = arch.qkv(x, lp, cfgl, positions, inv_freq)
        with span("prefill.write"):
            enc_shape = codeword_shape(policy.codec, k.shape, cfg.head_dim)
            km, vm = ([draw(enc_shape, N_BITS[policy.codec]) for _ in range(2)] if winject
                      else (None, None))
            kc, ks, _ = encode_kv(k, policy, mask=km)
            vc, vs, _ = encode_kv(v, policy, mask=vm)
            kcs = swar.scrub_codewords(policy.codec, kc) if scrub else kc
            vcs = swar.scrub_codewords(policy.codec, vc) if scrub else vc
            _write_tokens(state, i, block_table, positions, pack_kv(kcs, policy, cfg.head_dim),
                          pack_kv(vcs, policy, cfg.head_dim), ks, vs)
        with span("prefill.codec_read"):
            if read:
                rk, rv = ([_rank_slice(read_masks[i, j], mesh, 0, B, cfgl.num_kv_heads,
                                       batch_split) for j in (0, 1)]
                          if read_masks is not None else
                          [draw(kc.shape, N_BITS["int4"]) for _ in range(2)])
                k_dec = decode_kv(kc, ks, policy, head_dim=cfg.head_dim, read_mask=rk)[0]
                v_dec = decode_kv(vc, vs, policy, head_dim=cfg.head_dim, read_mask=rv)[0]
            else:
                k_dec = decode_kv(kc, ks, policy, head_dim=cfg.head_dim, seq_axis=1)[0]
                v_dec = decode_kv(vc, vs, policy, head_dim=cfg.head_dim, seq_axis=1)[0]
        with span("prefill.attention"):
            attn = causal_attention(q, k_dec.to(x.dtype), v_dec.to(x.dtype),
                                    cfg.num_kv_groups, sliding_window=cfg.sliding_window)
        with span("prefill.out_mlp"):
            x = arch.attn_out_mlp(x, attn, lp, cfgl, reduce)
    with span("prefill.lm_head"):
        if logit_pos is None:
            x_last = x[:, -1:, :]
        else:
            x_last = torch.take_along_dim(x, logit_pos.long().to(device)[:, None, None], dim=1)
        logits = _lm_head(params, x_last, cfgl, mesh)[:, 0]
    state["context_len"] = (torch.full((B,), S, dtype=torch.int32, device=device)
                            if true_len is None
                            else torch.as_tensor(true_len, dtype=torch.int32).to(device))
    return logits, state


def _prefill_latent(params, input_ids, state, block_table, cfg: ModelConfig,
                    policy: KVCachePolicy, generator, logit_pos, true_len):
    """prefill of a latent model: per layer the cache row written through
    the write chain (one mask a layer), read back through the codec (an
    uncorrectable Golay word keeps its data) and attended in the
    non-absorbed form (deepseek_v2.prefill_attention)."""
    scrub = _use_scrub(policy)
    B, S = input_ids.shape
    device = input_ids.device
    positions = torch.arange(S, device=device).expand(B, S)
    arch = arch_module(cfg)
    with span("prefill.embed"):
        inv_freq = arch.inv_freq(cfg, device)
        x = arch.embed(params, input_ids, cfg, positions)
    for i, lp in enumerate(params["layers"]):
        with span("prefill.qkv"):
            q, row = arch.qkv(x, lp, cfg, positions, inv_freq)
        with span("prefill.write"):
            mask = None
            if write_inject(policy):
                if generator is None:
                    raise ValueError("fault injection needs masks or a torch.Generator")
                mask = flip_mask(codeword_shape(policy.codec, row.shape, cfg.head_dim),
                                 policy.ber, N_BITS[policy.codec], generator)
            rc, rs, _ = encode_kv(row, policy, mask=mask)
            stored = swar.scrub_codewords(policy.codec, rc) if scrub else rc
            bs = state["kv_cache"].shape[4]
            _write_rows(state, "kv", i, _physical_pages(block_table, positions, bs),
                        (positions % bs).long(), pack_kv(stored, policy, cfg.head_dim), rs)
        with span("prefill.codec_read"):
            read = decode_kv(rc, rs, policy, head_dim=cfg.head_dim, seq_axis=1)[0]
        with span("prefill.attention"):
            attn = arch.prefill_attention(q, read.to(x.dtype), lp, cfg)
        x = arch.attn_out_mlp(x, attn, lp, cfg, "prefill", i)
    with span("prefill.lm_head"):
        if logit_pos is None:
            x_last = x[:, -1:, :]
        else:
            x_last = torch.take_along_dim(x, logit_pos.long().to(device)[:, None, None], dim=1)
        logits = arch.lm_head(params, x_last, cfg)[:, 0]
    state["context_len"] = (torch.full((B,), S, dtype=torch.int32, device=device)
                            if true_len is None
                            else torch.as_tensor(true_len, dtype=torch.int32).to(device))
    return logits, state


def write_mask_shape(policy: KVCachePolicy, batch: int, cfg: ModelConfig):
    """Logical injection-mask shape of one decode token's K or V write: the
    d12 codeword array for golay, padded nibbles otherwise (fp8: its bytes,
    one a value)."""
    pv = swar.padded_values(policy.codec, cfg.head_dim)
    return (batch, 1, cfg.num_kv_heads, pv // 3 if policy.codec == "golay" else pv)


@torch.no_grad()
def decode_step(params, token_ids, state, block_table, cfg: ModelConfig,
                policy: KVCachePolicy, generator=None, block_size: int = 128,
                collect_ecc_stats: bool = False, *, hoisted_masks=None,
                read_inject_seed=None, mesh=None):
    """One decode step: token_ids [B] -> logits [B, V] float32; the caches
    advance in place. A row whose block-table page is -1 (an inactive
    serving slot, context 0) writes into the trash page 0: its data column
    where the kernels clamp it, its parity column at slot b % block_size.

    Positional arguments are JAX's (``_decode_step_impl``), a
    ``torch.Generator`` in place of ``step_key``; ``block_size`` must be the
    cache's page size (it raises otherwise); ``hoisted_masks``,
    ``read_inject_seed`` and ``mesh`` are keyword-only.

    hoisted_masks: every layer's write masks for this step, [L, 2, *shape] -
    folded deltas (kv_policy.hoisted_write_deltas, uint8) in the scrubbed
    modes, raw logical masks (kv_policy.hoisted_logical_masks: uint8, int32
    for golay; fp8: its bytes' masks) otherwise. Drawn here from
    ``generator`` in one chain when write injection is on and none are
    given.

    collect_ecc_stats: turn scrub off (the correcting read counts per read)
    and add the kernels' per-sequence counts of every layer into
    state["ecc_corrected"] / state["ecc_detected"] ([B] int32; mode int4
    counts its flipped read bits in the first).

    read_inject_seed: the seed of mode int4's read flips this step (an int,
    or an int32 scalar tensor that the kernel reads on the card without a
    host sync); drawn from ``generator`` on its device when not given.

    mesh: as prefill's. The kernels run on the rank's KV heads; the
    hoisted masks are drawn (or given) at the single-device shape of the
    whole batch and sliced; the step's ECC counts are summed over the model
    group once. Mode int4's read flips hash the rank's local head index, as
    JAX's do, so they differ from the single-device run's."""
    _check_slice(cfg, policy)
    if is_latent(cfg):
        if mesh is not None:
            refuse_latent(cfg, "a mesh (parallel/)")
        return _decode_step_latent(params, token_ids, state, block_table, cfg, policy, generator,
                                   block_size, collect_ecc_stats, hoisted_masks)
    tp, dp, cfgl, reduce = _mesh_parts(cfg, mesh)
    bs = _check_block_size(state, block_size)
    B = token_ids.shape[0]
    Hl = cfgl.num_kv_heads
    L = len(params["layers"])
    pos = state["context_len"]
    positions = pos[:, None]
    dw = state["k_cache"].shape[3]
    device = token_ids.device
    arch = arch_module(cfg)
    scrub = _use_scrub(policy) and not collect_ecc_stats
    ri_ber = policy.ber if read_inject(policy) else 0.0
    inject = write_inject(policy)
    with span("decode.masks"):
        if ri_ber and read_inject_seed is None:
            if generator is None:
                raise ValueError("read-time injection needs a read_inject_seed or a "
                                 "torch.Generator")
            read_inject_seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=generator,
                                             device=generator.device).to(torch.int32)
        if inject:
            if hoisted_masks is None:
                hoist = hoisted_write_deltas if scrub else hoisted_logical_masks
                hoisted_masks = hoist(policy, L, write_mask_shape(policy, B * dp, cfg),
                                      generator=generator)
            hoisted_masks = _rank_slice(hoisted_masks, mesh, 2, B, Hl)
    with span("decode.embed"):
        inv_freq = arch.inv_freq(cfg, device)
        # gpt2's position rows: each row's context length
        x = arch.embed(params, token_ids[:, None], cfg, positions)
        ctx = pos + 1
        counts = torch.zeros((2, B), dtype=torch.int32, device=device)
    # scrubbed: the kernel reads data words only and the parity columns are
    # stored at the end of the step; otherwise parity streams through it
    has_parity = "k_parity" in state
    extract = scrub and has_parity and swar.scrub_extract_ok(policy.codec, cfg.head_dim)
    parity_args = (state["k_parity"], state["v_parity"]) if has_parity and not extract else ()
    k_par, v_par = [], []
    for i, lp in enumerate(params["layers"]):
        with span("decode.qkv"):
            q, k, v = arch.qkv(x, lp, cfgl, positions, inv_freq)
        with span("decode.write_chain"):
            masks = hoisted_masks[i] if inject else (None, None)
            if scrub:
                kc, ks = encode_pack_kv_scrubbed(k, policy, folded=masks[0])
                vc, vs = encode_pack_kv_scrubbed(v, policy, folded=masks[1])
            else:
                kc, ks, _ = encode_kv(k, policy, mask=masks[0])
                vc, vs, _ = encode_kv(v, policy, mask=masks[1])
                kc, vc = pack_kv(kc, policy, cfg.head_dim), pack_kv(vc, policy, cfg.head_dim)
            kc, vc = kc[:, 0], vc[:, 0]  # [B, Hkv, row_words]
            if ks is None:  # float codecs carry no scales: ones, as JAX passes
                ks = vs = torch.ones((B, 1, Hl), device=kc.device)
            if extract:
                k_par.append(kc[..., dw:])
                v_par.append(vc[..., dw:])
                kc, vc = kc[..., :dw], vc[..., :dw]
            kc, vc = kc.contiguous(), vc.contiguous()
            ks, vs = ks[:, 0].contiguous(), vs[:, 0].contiguous()
        with span("decode.attend"):
            out = paged_attention_ecc_write_attend(
                q[:, 0], kc, vc, ks, vs,
                state["k_cache"], state["v_cache"], state["k_scales"], state["v_scales"],
                block_table, ctx, i, *parity_args, codec=policy.codec, scrub=scrub,
                block_size=bs, use_interpolation=policy.use_interpolation,
                collect_stats=collect_ecc_stats, read_inject_ber=ri_ber,
                read_inject_seed=read_inject_seed if ri_ber else 0,
                sliding_window=cfg.sliding_window,
            )
            if collect_ecc_stats:
                attn, stats = out
                counts += stats.t()
            else:
                attn = out
        with span("decode.out_mlp"):
            x = arch.attn_out_mlp(x, attn[:, None], lp, cfgl, reduce)
    with span("decode.parity_scatter"):
        if k_par:
            # parity[l, phys[b], h, :, slot[b]] = col[b, l, h, :], all layers at once
            phys, slots = _trash_routed_slots(block_table, pos, bs)
            layers = torch.arange(L, device=phys.device)[None, :]
            kp = torch.stack(k_par, dim=1)  # [B, L, Hkv, pw]
            vp = torch.stack(v_par, dim=1)
            idx = (layers, phys[:, None], slice(None), slice(None), slots[:, None])
            state["k_parity"][idx] = kp
            state["v_parity"][idx] = vp
    with span("decode.ecc_counts"):
        if collect_ecc_stats:
            if mesh is not None:
                all_reduce(counts, mesh.model_group)  # once a step
            zeros = torch.zeros((B,), dtype=torch.int32, device=device)
            state["ecc_corrected"] = state.get("ecc_corrected", zeros) + counts[0]
            state["ecc_detected"] = state.get("ecc_detected", zeros) + counts[1]
    state["context_len"] = ctx
    with span("decode.lm_head"):
        logits = _lm_head(params, x, cfgl, mesh)[:, 0]
    return logits, state


def _decode_step_latent(params, token_ids, state, block_table, cfg: ModelConfig,
                        policy: KVCachePolicy, generator, block_size, collect_ecc_stats,
                        hoisted_masks):
    """decode_step of a latent model: the step's write masks (drawn here in
    one chain when none are given: [L, 1, ...], folded deltas when
    scrubbed, raw masks otherwise), then ``_latent_body``, then the counts
    into the state. On the card the body runs as a CUDA graph
    (``LatentGraph``, one a cache in ``_LATENT_GRAPHS``: captured at the
    second call with the same arrays and shapes, replayed after) unless
    tracing is recording; the first call and every CPU call run it
    eagerly. No host sync but the capture's."""
    bs = _check_block_size(state, block_size)
    B = token_ids.shape[0]
    scrub = _use_scrub(policy) and not collect_ecc_stats
    inject = write_inject(policy)
    with span("decode.masks"):
        if inject and hoisted_masks is None:
            hoist = hoisted_write_deltas if scrub else hoisted_logical_masks
            hoisted_masks = hoist(policy, len(params["layers"]), write_mask_shape(policy, B, cfg),
                                  generator=generator, rows=1)
    pos = state["context_len"]
    args = (params, cfg, policy, bs, collect_ecc_stats, scrub)
    inputs = (token_ids, pos, hoisted_masks, block_table)
    if token_ids.device.type == "cuda" and not tracing.recording():
        graph = _LATENT_GRAPHS.get(state["kv_cache"])
        if graph is None or not graph.fits(state, *args, *inputs):
            graph = _LATENT_GRAPHS[state["kv_cache"]] = LatentGraph(state, *args, *inputs)
        logits, counts = graph.run(state, *inputs)
    else:
        logits, counts = _latent_body(state, *args, *inputs)
    with span("decode.ecc_counts"):
        if collect_ecc_stats:
            zeros = torch.zeros((B,), dtype=torch.int32, device=pos.device)
            state["ecc_corrected"] = state.get("ecc_corrected", zeros) + counts[0]
            state["ecc_detected"] = state.get("ecc_detected", zeros) + counts[1]
    state["context_len"] = pos + 1
    return logits, state


# the latent model's decode graphs, one a cache: keyed by the state's
# kv_cache tensor (by identity), dropped with it
_LATENT_GRAPHS = WeakIdKeyDictionary()


def _latent_body(state, params, cfg: ModelConfig, policy: KVCachePolicy, bs: int,
                 collect_ecc_stats: bool, scrub: bool, token_ids, pos, hoisted_masks,
                 block_table):
    """The latent model's step past its masks: per layer the projections
    and RoPE, q_nope . W_UK (``decode.absorb``), the write chain of the one
    cache row, the latent read (every context row decoded once, for all
    heads), then W_UV, o_proj and the MLP or expert layer; the scrubbed
    modes' parity column; the LM head. Returns (logits [B, V] float32, the
    step's counts [2, B] int32)."""
    B = token_ids.shape[0]
    positions = pos[:, None]
    device = token_ids.device
    arch = arch_module(cfg)
    inject = hoisted_masks is not None
    dw = state["kv_cache"].shape[3]
    with span("decode.embed"):
        inv_freq = arch.inv_freq(cfg, device)
        x = arch.embed(params, token_ids[:, None], cfg, positions)
        ctx = pos + 1
        counts = torch.zeros((2, B), dtype=torch.int32, device=device)
    parity = []
    for i, lp in enumerate(params["layers"]):
        with span("decode.qkv"):
            q, row = arch.qkv(x, lp, cfg, positions, inv_freq)
        with span("decode.absorb"):
            qa = arch.absorb(q, lp, cfg)
        with span("decode.write_chain"):
            mask = hoisted_masks[i, 0] if inject else None
            if scrub:
                rc, rs = encode_pack_kv_scrubbed(row, policy, folded=mask)
            else:
                rc, rs, _ = encode_kv(row, policy, mask=mask)
                rc = pack_kv(rc, policy, cfg.head_dim)
            rc, rs = rc[:, 0], rs[:, 0]  # [B, 1, row_words], [B, 1]
            if scrub:
                parity.append(rc[..., dw:])
                rc = rc[..., :dw]
            rc, rs = rc.contiguous(), rs.contiguous()
        with span("decode.attend"):
            out = paged_latent_write_attend(
                qa, rc, rs, state["kv_cache"], state["kv_scales"], block_table, ctx, i,
                None if scrub else state["kv_parity"], scrub=scrub, block_size=bs,
                sm_scale=arch.softmax_scale(cfg), pv_width=cfg.kv_lora_rank,
                collect_stats=collect_ecc_stats)
            if collect_ecc_stats:
                attn, stats = out
                counts += stats.t()
            else:
                attn = out
        x = arch.attn_out_mlp(x, attn[:, None], lp, cfg, "decode", i, latent=True)
    with span("decode.parity_scatter"):
        if parity:
            phys, slots = _trash_routed_slots(block_table, pos, bs)
            layers = torch.arange(len(parity), device=phys.device)[None, :]
            idx = (layers, phys[:, None], slice(None), slice(None), slots[:, None])
            state["kv_parity"][idx] = torch.stack(parity, dim=1)  # [B, L, 1, pw]
    with span("decode.lm_head"):
        logits = arch.lm_head(params, x, cfg)[:, 0]
    return logits, counts


class LatentGraph:
    """The latent model's step body (``_latent_body``) as a CUDA graph over
    static copies of its inputs (tokens, context lengths, masks, block
    table): the first ``run`` is eager (the kernels' and libraries' first
    calls), the second captures and replays, every later one copies its
    inputs in and replays. The cache is updated in place, as eagerly; the
    logits and counts are returned as copies. It fits a call with the same
    parameters and cache arrays (by address: every array the body reads or
    writes), shapes and flags; it holds no reference to the state. A replay
    adds the launches the capture counted to the wrappers' ``.launches``
    and ``.launches_by`` (_COUNTED), so they count what runs on the card."""

    def __init__(self, state, params, cfg, policy, bs, collect_ecc_stats, scrub, token_ids, pos,
                 hoisted_masks, block_table):
        self.args = (params, cfg, policy, bs, collect_ecc_stats, scrub)
        self.key = self._key(state, *self.args, token_ids, pos, hoisted_masks, block_table)
        self.graph = None
        self.calls = 0

    @staticmethod
    def _key(state, params, cfg, policy, bs, collect_ecc_stats, scrub, token_ids, pos,
             hoisted_masks, block_table):
        shape = None if hoisted_masks is None else (tuple(hoisted_masks.shape), hoisted_masks.dtype)
        # the latent model's tree: its top-level arrays and a dict of arrays
        # a layer (read without tree_leaves' paths: the key is made each step)
        arrays = [t.data_ptr() for k, t in params.items() if k != "layers"]
        arrays += [t.data_ptr() for lp in params["layers"] for t in lp.values()]
        arrays += [state[k].data_ptr() for k in ("kv_cache", "kv_parity", "kv_scales")]
        return (id(params), tuple(arrays), cfg, policy, bs, collect_ecc_stats, scrub,
                tuple(token_ids.shape), shape, tuple(block_table.shape))

    def fits(self, *args):
        return self._key(*args) == self.key

    def run(self, state, token_ids, pos, hoisted_masks, block_table):
        self.calls += 1
        if self.calls == 1:
            return _latent_body(state, *self.args, token_ids, pos, hoisted_masks, block_table)
        inputs = [t for t in (token_ids, pos, hoisted_masks, block_table) if t is not None]
        if self.graph is None:
            self.inputs = [t.clone() for t in inputs]
            torch.cuda.synchronize()
            before = _launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                tok, p, *rest = self.inputs
                masks = rest[0] if hoisted_masks is not None else None
                self.outputs = _latent_body(state, *self.args, tok, p, masks, rest[-1])
            # what the capture counted runs at each replay, the first included
            self.launched = [(n - n0, {k: by[k] - by0[k] for k in by})
                             for (n, by), (n0, by0) in zip(_launch_counts(), before)]
        else:
            for w, (n, by) in zip(_COUNTED, self.launched):
                w.launches += n
                for k, d in by.items():
                    w.launches_by[k] += d
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        return self.outputs[0].clone(), self.outputs[1].clone()


# the counted kernel wrappers the latent step calls
_COUNTED = (paged_latent_write_attend, grouped_mm)


def _launch_counts():
    return [(w.launches, dict(getattr(w, "launches_by", {}))) for w in _COUNTED]


@torch.no_grad()
def decode_loop(params, logits, state, block_table, cfg: ModelConfig,
                policy: KVCachePolicy, generator, num_steps: int,
                block_size: int = 128, collect_ecc_stats: bool = False):
    """``num_steps`` greedy decode steps in a Python loop, each step's write
    masks (folded deltas or raw logical masks, as the mode writes) or read
    seed drawn from ``generator``. With ``collect_ecc_stats`` the counters
    state["ecc_corrected"] / state["ecc_detected"] start at 0 when absent
    and add up over the steps. Arguments are JAX's, in its order (a
    ``torch.Generator`` in place of ``base_key``); ``block_size`` must be
    the cache's page size.

    Returns (logits [B, V] after the last step, state, tokens [num_steps, B]
    - the argmax token fed into each step)."""
    _check_slice(cfg, policy)
    _check_block_size(state, block_size)
    if collect_ecc_stats:
        B = logits.shape[0]
        for name in ("ecc_corrected", "ecc_detected"):
            state.setdefault(name, torch.zeros((B,), dtype=torch.int32, device=logits.device))
    tokens = []
    for _ in range(num_steps):
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok)
        logits, state = decode_step(params, tok, state, block_table, cfg, policy,
                                    generator, block_size, collect_ecc_stats)
    return logits, state, torch.stack(tokens)


@torch.no_grad()
def generate(params, input_ids, cfg: ModelConfig, policy: KVCachePolicy,
             max_new_tokens: int = 32, block_size: int = 128, temperature: float = 0.0,
             seed: int = 0, return_ecc_stats: bool = False, *, device=None):
    """Greedy (``temperature`` 0) or sampled generation on ``device``
    (None: the card), masks and read seeds drawn from a generator seeded
    with policy.seed; sampling draws from a generator seeded with ``seed``
    on the device (sample_tokens). input_ids: [B, S] ints. Returns
    [B, S + max_new_tokens], or with ``return_ecc_stats`` (tokens,
    {"errors_corrected": [B], "errors_detected": [B]}), the decode steps'
    counts. Arguments are JAX's, in its order, and ``device`` the port's
    own, keyword-only."""
    device = resolve_device(device)
    input_ids = torch.as_tensor(input_ids).to(device=device, dtype=torch.long)
    B, S = input_ids.shape
    state, block_table, _ = init_generation_state(
        cfg, policy, B, S + max_new_tokens, block_size, device=device)
    generator = torch.Generator(device=device).manual_seed(policy.seed)
    logits, state = prefill(params, input_ids, state, block_table, cfg, policy, generator)
    sample_gen = torch.Generator(device=device).manual_seed(seed) if temperature > 0 else None
    tokens = [input_ids]
    for step in range(max_new_tokens):
        tok = (sample_tokens(logits, temperature, sample_gen) if temperature > 0
               else torch.argmax(logits, dim=-1))
        tokens.append(tok[:, None])
        if step == max_new_tokens - 1:
            break
        logits, state = decode_step(params, tok, state, block_table, cfg, policy, generator,
                                    block_size, return_ecc_stats)
    out = torch.cat(tokens, dim=1)
    if return_ecc_stats:
        zeros = torch.zeros((B,), dtype=torch.int32, device=device)
        return out, {"errors_corrected": state.get("ecc_corrected", zeros),
                     "errors_detected": state.get("ecc_detected", zeros)}
    return out
