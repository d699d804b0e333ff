"""The port's parallel layer (qkv_ecc_tpu_torch.parallel, serving/tp_server)
against the JAX package, on the CPU.

One group of 4 gloo ranks (parallel/launch.spawn) is started once for the
module and runs every distributed case (``rank_cases``, which imports no
JAX); the parent computes the JAX references meanwhile and compares. Each
rank returns its results to the parent as a file. The cases:

  * TP against JAX's single-device runtime: CFG_TP (tiny-llama at 8/4
    heads) on a 2x2 mesh and tiny-gpt2 on 1x4 (one head a shard), in
    int4-hamming84 and int12-golay: prefill at BER 0 (logits within rtol
    1e-4, atol 1e-5), then STEPS decode steps at BER 1e-2 on JAX's masks
    (numpy-made raw masks, folded by each package): every rank's stored
    words equal the (data rows, KV heads) slice of JAX's cache, its scales
    within rtol 1e-3, logits within atol 1e-3 (test_torch_runtime's
    tolerances, whose docstring gives their reasons: an ulp of difference
    in a scale moves one bf16-rounded softmax weight), greedy tokens equal;
  * the ECC counts with collect_ecc_stats (CFG_TP on 1x4 in hamming84,
    on JAX's per-layer masks from its keys): equal to JAX's every step, as
    are the stored words (golay's and the other meshes' counts are held to
    the port's single-device run below, which test_torch_runtime holds to
    JAX's);
  * generate_tp at BER 0 against JAX's generate: equal tokens;
  * the port's own full draw + slice (a generator, BER 1e-2): generate_tp
    and the stepwise run equal the port's single-device run - stored words
    and ECC counts bit for bit, tokens equal, scales and logits within the
    tolerances above (the row-parallel sums reassociate float additions);
  * context parallelism over 4 ranks (K4 with its softmax state, merged by
    merge_softmax_shards) in int4, hamming84 and golay against JAX's
    paged_attention_ecc on the whole cache within 1e-4 - its plain
    reference, paged_attention_ecc_reference, which its Pallas kernel is
    tested against (interpret mode takes minutes at these sizes) - and a
    case with empty shards finite;
  * TPContinuousBatchingServer on 2x2 against JAX's single-device server
    (its tests/test_serving.py:250-306 assertions: the admitted cache equal
    within 1e-6, one decode step's logits within 1e-4, over 0.7 of the
    served tokens equal), and against the port's single-device server at
    BER 1e-2 (own draws): equal streams and ECC counts;
  * create_mesh's shapes and errors over the group.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from qkv_ecc_tpu_torch.kernels.paged_attention import paged_attention_ecc
from qkv_ecc_tpu_torch.models import runtime as tr
from qkv_ecc_tpu_torch.models.config import TINY_GPT2, TINY_LLAMA
from qkv_ecc_tpu_torch.models.kv_policy import hoisted_write_deltas, policy_for_mode
from qkv_ecc_tpu_torch.models.registry import params_from_jax
from qkv_ecc_tpu_torch.parallel import sharding
from qkv_ecc_tpu_torch.parallel.context_parallel import make_cp_attention, shard_context
from qkv_ecc_tpu_torch.parallel.mesh import all_gather_cat, create_mesh
from qkv_ecc_tpu_torch.parallel.tp_runtime import generate_tp, local_rows, make_tp_functions
from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer, Request, TPContinuousBatchingServer

torch.set_num_threads(1)

CFG_TP = dataclasses.replace(TINY_LLAMA, num_heads=8, num_kv_heads=4, name="tiny-llama-tp")
CFG_SRV = dataclasses.replace(TINY_LLAMA, num_heads=8, num_kv_heads=4, head_dim=8,
                              name="tp-serve")
CFGS = {"llama": CFG_TP, "gpt2": TINY_GPT2}
B, PROMPT, STEPS, BS, BER = 2, 21, 4, 16, 1e-2
T = PROMPT + STEPS + 2
WORLD = 4
# (arch, mode, data, model, stats): the stepwise cases against JAX
STEP_CASES = (("llama", "int4-hamming84", 2, 2, False), ("llama", "int12-golay", 2, 2, False),
              ("gpt2", "int4-hamming84", 1, 4, False), ("gpt2", "int12-golay", 1, 4, False),
              ("llama", "int4-hamming84", 1, 4, True))
# (arch, mode, data, model): generate_tp at BER 0 against JAX's generate
GEN_CASES = (("llama", "int4-hamming84", 2, 2), ("gpt2", "int12-golay", 1, 4))
# (arch, mode, data, model, stats): the port's TP against its single-device run
OWN_CASES = (("llama", "int4-hamming84", 2, 2, False), ("llama", "int12-golay", 1, 4, False),
             ("llama", "int4-write-inject", 2, 2, False), ("gpt2", "fp8", 1, 4, False),
             ("gpt2", "int4-hamming84", 2, 2, True), ("llama", "int12-golay", 1, 2, True))
CP_CASES = (("int4", (90, 70)), ("hamming84", (90, 70)), ("golay", (90, 70)),
            ("hamming84", (20, 5)))
CP_HKV, CP_HQ, CP_D, CP_PAGES = 2, 4, 64, 8
CACHE = ("k_cache", "v_cache", "k_parity", "v_parity", "k_scales", "v_scales")


def case_id(case):
    return "-".join(str(c) for c in case)


def numpy_masks(rng, shape, ber, n_bits):
    flips = rng.random((n_bits,) + tuple(shape)) < ber
    return (flips.astype(np.int64) << np.arange(n_bits).reshape((n_bits,) + (1,) * len(shape))
            ).sum(0).astype(np.int32)


def rank_slice(full, data_index, model_index, data, model, bt_full):
    """The (data rows' pages, KV heads) slice of a single-device cache array
    that rank (data_index, model_index) holds, and the same pages of the
    rank's own array."""
    hl = full.shape[2] // model
    b = bt_full.shape[0] // data
    pages = bt_full[data_index * b:(data_index + 1) * b].reshape(-1)
    return full[:, pages, model_index * hl:(model_index + 1) * hl], pages


# -- the ranks' side: no JAX ------------------------------------------------------


def _bits(t):
    """A tensor as numpy, the float codecs' stored values as their bits."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    return t.numpy().copy()


def _state_np(state):
    return {k: _bits(v) for k, v in state.items() if k in CACHE}


def _stepwise(cfg, params, mode, ids, data, model, masks, stats):
    """Prefill at BER 0, then STEPS decode steps on the given full-shape
    masks; this rank's logits, tokens, counts and caches."""
    mesh = create_mesh(data, model, device="cpu")
    if not mesh.active:
        return None
    pol0, pol = policy_for_mode(mode, 0.0), policy_for_mode(mode, BER)
    if stats:
        pol = dataclasses.replace(pol, scrub=False)
    local = sharding.shard_params(params, cfg, mesh)
    init_state, prefill, _ = make_tp_functions(cfg, pol0, mesh, BS)
    _, _, decode_step = make_tp_functions(cfg, pol, mesh, BS, collect_ecc_stats=stats)
    state, bt = init_state(B, T)
    logits, state = prefill(local, local_rows(ids, mesh), state, bt)
    out = {"prefill_logits": logits.numpy(), "logits": [], "tokens": [], "counts": []}
    for step in range(STEPS):
        tok = torch.argmax(logits, dim=-1)
        out["tokens"].append(tok.numpy())
        hm = masks[step]
        if not stats:
            hm = hoisted_write_deltas(pol, cfg.num_layers, hm.shape[2:], raw_masks=hm)
        logits, state = decode_step(local, tok, state, bt, hoisted_masks=hm)
        out["logits"].append(logits.numpy())
        if stats:
            out["counts"].append(np.stack([state["ecc_corrected"].numpy(),
                                           state["ecc_detected"].numpy()]))
    out.update(state=_state_np(state), rank=(mesh.data_index, mesh.model_index))
    return out


def _own(cfg, params, mode, ids, data, model, stats):
    """The port's TP against its single-device run on the same generator
    draws: the rank's slice compared here; returns the differences."""
    mesh = create_mesh(data, model, device="cpu")
    if not mesh.active:
        return None
    pol = policy_for_mode(mode, BER, seed=3)
    if stats:
        pol = dataclasses.replace(pol, scrub=False)
    tp_tokens = generate_tp(params, ids, cfg, pol, mesh, max_new_tokens=STEPS, block_size=BS)
    ref_tokens = tr.generate(params, ids, cfg, pol, max_new_tokens=STEPS, block_size=BS,
                             device="cpu")
    # stepwise, on a generator of each
    runs = []
    for tp in (True, False):
        g = torch.Generator().manual_seed(5)
        if tp:
            local = sharding.shard_params(params, cfg, mesh)
            init_state, prefill, decode_step = make_tp_functions(cfg, pol, mesh, BS,
                                                                 collect_ecc_stats=stats)
            state, bt = init_state(B, T)
            logits, state = prefill(local, local_rows(ids, mesh), state, bt, g)
            step = lambda tok, st: decode_step(local, tok, st, bt, g)  # noqa: E731
        else:
            state, bt, _ = tr.init_generation_state(cfg, pol, B, T, BS, device="cpu")
            logits, state = tr.prefill(params, ids, state, bt, cfg, pol, g)
            step = lambda tok, st: tr.decode_step(params, tok, st, bt, cfg, pol, g, BS,  # noqa
                                                  stats)
            full_bt = bt.numpy()
        toks, lgs = [], []
        for _ in range(STEPS):
            toks.append(torch.argmax(logits, -1))
            logits, state = step(toks[-1], state)
            lgs.append(logits)
        runs.append((state, torch.stack(toks), torch.stack(lgs)))
    (ts, tt, tl), (ss, st, sl) = runs
    diffs = {"tokens": int((tp_tokens != ref_tokens).sum())}
    b = B // data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    diffs["step_tokens"] = int((tt != st[:, rows]).sum())
    diffs["logits"] = float((tl - sl[:, rows]).abs().max())
    for k in CACHE:
        if k not in ss:
            continue
        want, pages = rank_slice(_bits(ss[k]), mesh.data_index, mesh.model_index, data,
                                 model, full_bt)
        got = _bits(ts[k])[:, pages]
        if k.endswith("scales"):
            diffs[k] = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        else:
            diffs[k] = int((got != want).sum())
    if stats:
        diffs["counts"] = int(sum((ts[n] != ss[n][rows]).sum() for n in
                                  ("ecc_corrected", "ecc_detected")))
        diffs["count_total"] = int(ss["ecc_corrected"].sum())
    return diffs


def _cp(inputs, codec, contexts):
    """This rank's shard of the CP cache through make_cp_attention over a
    4-rank context group."""
    mesh = create_mesh(WORLD, 1, device="cpu")
    c = inputs["cp"][(codec, contexts)]
    n = c["shard"]["k_cache"].shape[1] // WORLD
    mine = {k: torch.from_numpy(v[:, mesh.data_index * n:(mesh.data_index + 1) * n].copy())
            for k, v in c["shard"].items()}
    parity = "k_parity" in mine
    fn = make_cp_attention(mesh, codec=codec, block_size=BS, precision="highest",
                           with_parity=parity)
    out = fn(torch.from_numpy(c["q"]), *(mine[k] for k in ("k_cache", "v_cache", "k_scales",
                                                           "v_scales")),
             torch.from_numpy(c["bt_shard"]), torch.from_numpy(c["local"]), 0,
             *((mine["k_parity"], mine["v_parity"]) if parity else ()))
    return out.numpy()


def _server(inputs):
    """TPContinuousBatchingServer on a 2x2 mesh: the JAX test's admission
    and one decode step, its staggered serve, and a BER 1e-2 golay serve
    beside the single-device server's."""
    mesh = create_mesh(2, 2, device="cpu")
    params = params_from_jax(inputs["srv_params"], CFG_SRV, device="cpu")
    prompts = inputs["srv_prompts"]

    def tp_server(mode="int4-hamming84", ber=0.0):
        return TPContinuousBatchingServer(params, CFG_SRV, policy_for_mode(mode, ber, seed=42),
                                          mesh, max_batch=4, max_seq_len=96, block_size=16)

    srv = tp_server()
    srv.add_request(Request(0, prompts[0], max_new_tokens=6))
    srv.add_request(Request(1, prompts[1], max_new_tokens=6))
    srv._try_admit()
    admitted = _state_np(srv.state)
    toks = torch.tensor([srv.slots[0].next_token, srv.slots[1].next_token, 0, 0])
    block_table = srv._block_table().numpy()
    step_logits = srv._run_decode(toks, srv._block_table()).numpy()
    srv2 = tp_server()
    srv2.add_request(Request(0, prompts[0], max_new_tokens=6))
    srv2.add_request(Request(1, prompts[1], max_new_tokens=6))
    srv2.step()
    srv2.add_request(Request(2, prompts[2], max_new_tokens=6))
    streams = {o.request_id: o.token_ids for o in srv2.run()}
    own = []
    for cls in (lambda: tp_server("int12-golay", BER),
                lambda: ContinuousBatchingServer(params, CFG_SRV,
                                                 policy_for_mode("int12-golay", BER, seed=42),
                                                 max_batch=4, max_seq_len=96, block_size=16,
                                                 device="cpu")):
        s = cls()
        for i, p in enumerate(prompts):
            s.add_request(Request(i, p, max_new_tokens=5))
        own.append(({o.request_id: o.token_ids for o in s.run()}, s.ecc_stats))
    return {"admitted": admitted, "step_logits": step_logits, "streams": streams, "own": own,
            "rank": (mesh.data_index, mesh.model_index), "block_table": block_table}


def _meshes():
    """create_mesh's shapes, groups and errors over the group, and all_gather_cat
    over a group and over none (an axis of one rank)."""
    out = {"default": create_mesh(device="cpu").shape, "2x2": create_mesh(2, 2, device="cpu").shape,
           "data2": create_mesh(2, device="cpu").shape}
    m = create_mesh(1, 2, device="cpu")
    out["1x2 active"] = m.active
    m = create_mesh(4, 1, device="cpu")  # an axis of one rank has no group
    out["4x1 groups"] = (m.model_group is None, m.data_group is not None)
    out["4x1 gather"] = all_gather_cat(torch.tensor([[m.rank]]), m.data_group, dim=0).tolist()
    out["4x1 one-rank gather"] = all_gather_cat(torch.tensor([m.rank]), m.model_group).tolist()
    try:
        create_mesh(3, 3, device="cpu")
        out["3x3"] = "no error"
    except ValueError as e:
        out["3x3"] = str(e)
    return out


def rank_cases(inputs):
    """Every distributed case on this rank, in one order on every rank
    (each builds its mesh's subgroups over the whole group)."""
    cfg_params = {a: params_from_jax(inputs["params"][a], CFGS[a], device="cpu") for a in CFGS}
    ids = torch.from_numpy(inputs["ids"])
    out = {"meshes": _meshes(), "step": {}, "gen": {}, "own": {}, "cp": {}}
    for case in STEP_CASES:
        arch, mode, data, model, stats = case
        masks = torch.from_numpy(inputs["masks"][case])
        out["step"][case] = _stepwise(CFGS[arch], cfg_params[arch], mode, ids, data, model,
                                      masks, stats)
    for case in GEN_CASES:
        arch, mode, data, model = case
        mesh = create_mesh(data, model, device="cpu")
        out["gen"][case] = generate_tp(cfg_params[arch], ids, CFGS[arch],
                                       policy_for_mode(mode, 0.0), mesh,
                                       max_new_tokens=STEPS + 1, block_size=BS).numpy()
    for case in OWN_CASES:
        arch, mode, data, model, stats = case
        out["own"][case] = _own(CFGS[arch], cfg_params[arch], mode, ids, data, model, stats)
    for codec, contexts in CP_CASES:
        out["cp"][(codec, contexts)] = _cp(inputs, codec, contexts)
    out["server"] = _server(inputs)
    return out


# -- the parent's side ------------------------------------------------------------


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def build_cp_cache(rng, codec, context_lens, num_shards):
    """JAX's _build (tests/test_context_parallel.py) on the port's encoder:
    one logical context as a single-device cache and as a block-sharded one
    with per-shard block tables and local lengths."""
    from qkv_ecc_tpu_torch.cache.layout import ECCCacheConfig, allocate_ecc_kv_cache
    from qkv_ecc_tpu_torch.kernels import swar

    batch = len(context_lens)
    local = shard_context(context_lens, num_shards, BS)
    offsets = np.zeros((num_shards, batch), np.int64)
    for s in range(1, num_shards):
        offsets[s] = offsets[s - 1] + local[s - 1]
    per = batch * CP_PAGES
    cc = ECCCacheConfig(num_blocks=num_shards * per, block_size=BS, num_layers=1,
                        num_kv_heads=CP_HKV, head_dim=CP_D, codec=codec)
    full = {k: v.numpy().copy() for k, v in allocate_ecc_kv_cache(cc, device="cpu").items()}
    shard = {k: v.copy() for k, v in full.items()}
    bt_full = np.full((batch, num_shards * CP_PAGES), -1, np.int32)
    bt_shard = np.full((num_shards, batch, CP_PAGES), -1, np.int32)
    for b, ctx in enumerate(context_lens):
        for name in ("k", "v"):
            x = rng.normal(size=(ctx, CP_HKV, CP_D)).astype(np.float32)
            absmax = np.abs(x).max(-1)
            scale = np.where(absmax == 0, 1.0, absmax / 7.0).astype(np.float32)
            qn = np.clip(np.round(x / scale[..., None]), -8, 7) + 8
            words = swar.encode_row(codec, torch.from_numpy(qn.astype(np.int32)), CP_D).numpy()
            for t in range(ctx):
                p, slot = divmod(t, BS)
                s = max(si for si in range(num_shards) if offsets[si, b] <= t)
                lp = p - offsets[s, b] // BS
                phys_full = b * num_shards * CP_PAGES + p
                phys_global = s * per + b * CP_PAGES + lp
                bt_full[b, p] = phys_full
                bt_shard[s, b, lp] = b * CP_PAGES + lp
                dw = full[f"{name}_cache"].shape[3]
                for arr, phys in ((full, phys_full), (shard, phys_global)):
                    arr[f"{name}_cache"][0, phys, :, :, slot] = words[t][..., :dw]
                    arr[f"{name}_scales"][0, phys, :, slot] = scale[t]
                    if f"{name}_parity" in arr:
                        arr[f"{name}_parity"][0, phys, :, :, slot] = words[t][..., dw:]
    return full, bt_full, shard, bt_shard, local


def jax_key_masks(jpol, key, shape, num_layers):
    """The write masks JAX's decode step draws per layer from its keys
    (collecting statistics): [L, 2, *shape]."""
    jax = _jax()
    from qkv_ecc_tpu.codecs.fault_injection import flip_mask_for
    from qkv_ecc_tpu.models import runtime as jr
    from qkv_ecc_tpu.models.kv_policy import N_BITS

    kv_key = jax.random.fold_in(key, 1000000)
    return np.stack([np.stack([np.asarray(flip_mask_for(k, shape, jpol.ber, N_BITS[jpol.codec]))
                               for k in jr._layer_kv_key(jpol, i, kv_key)])
                     for i in range(num_layers)]).astype(np.int32)


def make_inputs():
    jax = _jax()
    from qkv_ecc_tpu.models.config import TINY_GPT2 as J_GPT2
    from qkv_ecc_tpu.models.config import TINY_LLAMA as J_LLAMA
    from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy
    from qkv_ecc_tpu.models.registry import init_params as j_init

    jcfgs = {"llama": dataclasses.replace(J_LLAMA, num_heads=8, num_kv_heads=4,
                                          name="tiny-llama-tp"), "gpt2": J_GPT2}
    jparams = {a: j_init(c, 0) for a, c in jcfgs.items()}
    rng = np.random.default_rng(0)
    inputs = {"params": {a: jax.tree.map(np.asarray, p) for a, p in jparams.items()},
              "ids": rng.integers(0, 256, (B, PROMPT)), "masks": {}, "cp": {}}
    for case in STEP_CASES:
        arch, mode, data, model, stats = case
        pol = policy_for_mode(mode, BER)
        shape = tr.write_mask_shape(pol, B, CFGS[arch])
        if stats:
            jpol = j_policy(mode, BER)
            inputs["masks"][case] = np.stack([
                jax_key_masks(jpol, jax.random.fold_in(jax.random.key(7), s), shape,
                              CFGS[arch].num_layers) for s in range(STEPS)])
        else:
            from qkv_ecc_tpu_torch.models.kv_policy import N_BITS
            inputs["masks"][case] = np.stack([
                numpy_masks(rng, (CFGS[arch].num_layers, 2) + shape, BER, N_BITS[pol.codec])
                for _ in range(STEPS)])
    for codec, contexts in CP_CASES:
        full, bt_full, shard, bt_shard, local = build_cp_cache(rng, codec, contexts, WORLD)
        q = rng.normal(size=(len(contexts), CP_HQ, CP_D)).astype(np.float32)
        inputs["cp"][(codec, contexts)] = dict(full=full, bt_full=bt_full, shard=shard,
                                               bt_shard=bt_shard, local=local, q=q)
    srv_cfg = dataclasses.replace(jcfgs["llama"], head_dim=8, name="tp-serve")
    inputs["srv_params"] = jax.tree.map(np.asarray, j_init(srv_cfg, 3))
    inputs["srv_prompts"] = [rng.integers(0, 256, (n,)) for n in (7, 13, 5)]
    return inputs, jcfgs, jparams, srv_cfg


def jax_references(inputs, jcfgs, jparams, srv_cfg):
    jax = _jax()
    import jax.numpy as jnp
    from qkv_ecc_tpu.kernels import swar as js
    from qkv_ecc_tpu.kernels.paged_attention import paged_attention_ecc_reference as j_attend
    from qkv_ecc_tpu.models import runtime as jr
    from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy
    from qkv_ecc_tpu.serving import ContinuousBatchingServer as JServer
    from qkv_ecc_tpu.serving import Request as JRequest

    ids = jnp.asarray(inputs["ids"])
    ref = {"step": {}, "gen": {}, "cp": {}}
    for case in STEP_CASES:
        arch, mode, data, model, stats = case
        jcfg, jp = jcfgs[arch], jparams[arch]
        jpol0, jpol = j_policy(mode, 0.0), j_policy(mode, BER)
        if stats:
            jpol = dataclasses.replace(jpol, scrub=False)
        state, bt, _ = jr.init_generation_state(jcfg, jpol0, B, T, block_size=BS)
        key = jax.random.key(7)
        logits, state = jr.prefill(jp, ids, state, bt, jcfg, jpol0, key)
        r = {"prefill_logits": np.asarray(logits), "logits": [], "tokens": [], "counts": [],
             "bt": np.asarray(bt)}
        for step in range(STEPS):
            tok = jnp.argmax(logits, axis=-1)
            r["tokens"].append(np.asarray(tok))
            jh = None if stats else js.scrub_fold_mask(
                jpol.codec, jnp.asarray(inputs["masks"][case][step])).astype(jnp.uint8)
            logits, state = jr.decode_step(jp, tok, state, bt, jcfg, jpol,
                                           jax.random.fold_in(key, step), block_size=BS,
                                           hoisted_masks=jh, collect_ecc_stats=stats)
            r["logits"].append(np.asarray(logits))
            if stats:
                r["counts"].append(np.stack([np.asarray(state["ecc_corrected"]),
                                             np.asarray(state["ecc_detected"])]))
        r["state"] = {k: np.asarray(v) for k, v in state.items() if k in CACHE}
        ref["step"][case] = r
    for case in GEN_CASES:
        arch, mode, _, _ = case
        ref["gen"][case] = np.asarray(jr.generate(jparams[arch], ids, jcfgs[arch],
                                                  j_policy(mode, 0.0), max_new_tokens=STEPS + 1,
                                                  block_size=BS))
    for codec, contexts in CP_CASES:
        c = inputs["cp"][(codec, contexts)]
        full = c["full"]
        ref["cp"][(codec, contexts)] = np.asarray(j_attend(
            jnp.asarray(c["q"]), *(jnp.asarray(full[k]) for k in
                                   ("k_cache", "v_cache", "k_scales", "v_scales")),
            jnp.asarray(c["bt_full"]), jnp.asarray(np.asarray(contexts, np.int32)), 0,
            *((jnp.asarray(full["k_parity"]), jnp.asarray(full["v_parity"]))
              if "k_parity" in full else ()),
            codec=codec, block_size=BS))
    # JAX's single-device server, as its TP server test holds its TP server
    prompts = inputs["srv_prompts"]

    def jserver():
        return JServer(jparams_srv, srv_cfg, j_policy("int4-hamming84", 0.0, seed=42),
                       max_batch=4, max_seq_len=96, block_size=16)

    jparams_srv = jax.tree.map(jnp.asarray, inputs["srv_params"])
    base = jserver()
    base.add_request(JRequest(0, prompts[0], max_new_tokens=6))
    base.add_request(JRequest(1, prompts[1], max_new_tokens=6))
    base._try_admit()
    admitted = {k: np.asarray(v) for k, v in base.state.items() if k in CACHE}
    block_table = np.asarray(base._block_table())
    toks = jnp.asarray([base.slots[0].next_token, base.slots[1].next_token, 0, 0])
    step_logits = np.asarray(base._run_decode(toks, base._block_table(),
                                              jax.random.fold_in(base._key, 0)))
    base2 = jserver()
    base2.add_request(JRequest(0, prompts[0], max_new_tokens=6))
    base2.add_request(JRequest(1, prompts[1], max_new_tokens=6))
    base2.step()
    base2.add_request(JRequest(2, prompts[2], max_new_tokens=6))
    streams = {o.request_id: [int(t) for t in o.token_ids] for o in base2.run()}
    ref["server"] = {"admitted": admitted, "step_logits": step_logits, "streams": streams,
                     "block_table": block_table}
    return ref


@pytest.fixture(scope="module")
def runs():
    from qkv_ecc_tpu_torch.parallel.launch import spawn

    inputs, jcfgs, jparams, srv_cfg = make_inputs()
    here = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("PYTHONPATH", os.pathsep.join([here] + [p for p in [
            os.environ.get("PYTHONPATH")] if p]))  # the ranks import this module
        ranks = pool.submit(spawn, f"{os.path.splitext(os.path.basename(__file__))[0]}:rank_cases",
                            WORLD, backend="gloo", device="cpu", args=(inputs,), timeout=600)
        ref = jax_references(inputs, jcfgs, jparams, srv_cfg)
        return inputs, ranks.result(), ref


def test_rank_module_imports_no_jax():
    """The ranks import this module: its top level imports no JAX."""
    import ast

    tree = ast.parse(open(__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "qkv_ecc_tpu")]


def test_meshes_over_the_group(runs):
    _, ranks, _ = runs
    for r in ranks:
        m = r["meshes"]
        assert m["default"] == {"data": 1, "model": 4}
        assert m["2x2"] == {"data": 2, "model": 2}
        assert m["data2"] == {"data": 2, "model": 2}
        assert "needs more than 4 ranks" in m["3x3"]
    assert [r["meshes"]["1x2 active"] for r in ranks] == [True, True, False, False]
    for i, r in enumerate(ranks):
        assert r["meshes"]["4x1 groups"] == (True, True)
        assert r["meshes"]["4x1 gather"] == [[0], [1], [2], [3]]
        assert r["meshes"]["4x1 one-rank gather"] == [i]


@pytest.mark.parametrize("case", STEP_CASES, ids=case_id)
def test_tp_steps_match_jax(runs, case):
    inputs, ranks, ref = runs
    arch, mode, data, model, stats = case
    want = ref["step"][case]
    b = B // data
    for r in ranks:
        got = r["step"][case]
        if got is None:
            continue
        di, mi = got["rank"]
        rows = slice(di * b, (di + 1) * b)
        np.testing.assert_allclose(got["prefill_logits"], want["prefill_logits"][rows],
                                   rtol=1e-4, atol=1e-5)
        for step in range(STEPS):
            np.testing.assert_array_equal(got["tokens"][step], want["tokens"][step][rows])
            np.testing.assert_allclose(got["logits"][step], want["logits"][step][rows], rtol=0,
                                       atol=1e-3, err_msg=f"step {step}")
            if stats:
                np.testing.assert_array_equal(got["counts"][step], want["counts"][step][:, rows],
                                              err_msg=f"step {step}")
        for k, full in want["state"].items():
            w, pages = rank_slice(full, di, mi, data, model, want["bt"])
            g = got["state"][k][:, pages]
            if k.endswith("scales"):
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=0, err_msg=k)
            else:
                assert int((g != w).sum()) == 0, f"rank {di, mi} {k}: {(g != w).sum()} words differ"
    if stats:
        assert sum(c[0].sum() for c in want["counts"]) > 0


@pytest.mark.parametrize("case", GEN_CASES, ids=case_id)
def test_generate_tp_matches_jax_generate(runs, case):
    _, ranks, ref = runs
    for r in ranks:
        np.testing.assert_array_equal(r["gen"][case], ref["gen"][case])


@pytest.mark.parametrize("case", OWN_CASES, ids=case_id)
def test_tp_equals_single_device_run(runs, case):
    _, ranks, _ = runs
    stats = case[-1]
    for r in ranks:
        d = r["own"][case]
        if d is None:
            continue
        assert d["tokens"] == 0 and d["step_tokens"] == 0, d
        assert d["logits"] < 1e-3, d
        for k, v in d.items():
            if k in ("k_scales", "v_scales"):
                assert v < 1e-3, (k, d)
            elif k in CACHE:
                assert v == 0, (k, d)
        if stats:
            assert d["counts"] == 0 and d["count_total"] > 0, d


@pytest.mark.parametrize("case", CP_CASES, ids=case_id)
def test_cp_matches_jax(runs, case):
    inputs, ranks, ref = runs
    want = ref["cp"][case]
    local = inputs["cp"][case]["local"]
    if case[1] == (20, 5):  # trailing shards empty: they add nothing
        assert (local[2:] == 0).all()
    for r in ranks:
        out = r["cp"][case]
        assert np.isfinite(out).all()
        assert float(np.abs(out - want).max()) < 1e-4


def test_tp_server_matches_jax_server(runs):
    """JAX's test_tp_server_mesh_2x4_end_to_end's assertions, on a 2x2
    mesh, against JAX's single-device server."""
    _, ranks, ref = runs
    want = ref["server"]
    for r in ranks:
        got = r["server"]
        di, mi = got["rank"]
        for k, full in want["admitted"].items():
            hl = full.shape[2] // 2
            w = full[:, :, mi * hl:(mi + 1) * hl]
            assert np.abs(got["admitted"][k].astype(np.float64) - w).max() < 1e-6, k
        np.testing.assert_array_equal(got["block_table"], want["block_table"])
        rows = slice(di * 2, di * 2 + 2)
        assert np.abs(got["step_logits"] - want["step_logits"][rows]).max() < 1e-4
        match = total = 0
        assert len(got["streams"]) == 3
        for rid, toks in got["streams"].items():
            assert len(toks) == 6
            match += sum(a == b for a, b in zip(toks, want["streams"][rid]))
            total += len(toks)
        assert match / total > 0.7, (match, total)
        (tp_streams, tp_stats), (one_streams, one_stats) = got["own"]
        assert tp_streams == one_streams and tp_stats == one_stats
        assert tp_stats["errors_corrected"] > 0


def test_permute_gpt2_qkv_matches_jax():
    """The permuted c_attn equals JAX's, and each shard's columns are its
    heads' [Q_s | K_s | V_s] (JAX's roundtrip test)."""
    jax = _jax()
    from qkv_ecc_tpu.models.config import TINY_GPT2 as J_GPT2
    from qkv_ecc_tpu.models.registry import init_params as j_init
    from qkv_ecc_tpu.parallel.sharding import permute_gpt2_qkv as j_permute

    jparams = j_init(J_GPT2, 0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), TINY_GPT2, device="cpu")
    E, D = TINY_GPT2.num_heads * TINY_GPT2.head_dim, TINY_GPT2.head_dim
    for tp in (1, 2, 4):
        jp, tpp = j_permute(jparams, J_GPT2, tp), sharding.permute_gpt2_qkv(params, TINY_GPT2, tp)
        for jl, tl in zip(jp["layers"], tpp["layers"]):
            for n in ("w", "b"):
                np.testing.assert_array_equal(tl["c_attn"][n].numpy(), np.asarray(jl["c_attn"][n]))
        w0 = params["layers"][0]["c_attn"]["w"].numpy()
        wp = tpp["layers"][0]["c_attn"]["w"].numpy()
        hl, width = TINY_GPT2.num_heads // tp, 3 * E // tp
        for s in range(tp):
            q, k, v = np.split(wp[:, s * width:(s + 1) * width], 3, axis=1)
            sl = slice(s * hl * D, (s + 1) * hl * D)
            np.testing.assert_array_equal(q, w0[:, :E][:, sl])
            np.testing.assert_array_equal(k, w0[:, E:2 * E][:, sl])
            np.testing.assert_array_equal(v, w0[:, 2 * E:][:, sl])


@pytest.mark.parametrize("lens,shards,bs", [((90, 70), 4, 16), ((20, 5), 4, 16),
                                             ((0, 1, 129, 1000), 3, 128), ((300,), 8, 16)])
def test_shard_context_matches_jax(lens, shards, bs):
    from qkv_ecc_tpu.parallel.context_parallel import shard_context as j_shard

    got, want = shard_context(lens, shards, bs), j_shard(lens, shards, bs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["llama", "gpt2", "tied"])
def test_specs_cover_every_parameter_as_jax(arch):
    """The specs have the parameter tree's structure and JAX's sharded
    dimension on every leaf; cache_specs as JAX's."""
    jax = _jax()
    from jax.sharding import PartitionSpec as P
    from qkv_ecc_tpu.models.config import TINY_GPT2 as J_GPT2
    from qkv_ecc_tpu.models.config import TINY_LLAMA as J_LLAMA
    from qkv_ecc_tpu.models.registry import init_params as j_init
    from qkv_ecc_tpu.parallel.sharding import cache_specs as j_cache_specs
    from qkv_ecc_tpu.parallel.sharding import param_specs as j_specs
    from qkv_ecc_tpu_torch.models.registry import init_params, tree_leaves

    jcfg = J_GPT2 if arch == "gpt2" else J_LLAMA
    if arch == "tied":
        jcfg = dataclasses.replace(J_LLAMA, tie_word_embeddings=True)
    cfg = TINY_GPT2 if arch == "gpt2" else dataclasses.replace(
        TINY_LLAMA, tie_word_embeddings=jcfg.tie_word_embeddings)

    def dim(spec):
        return next((i for i, a in enumerate(spec) if a == "model"), None)

    want = jax.tree.map(dim, j_specs(jcfg), is_leaf=lambda x: isinstance(x, P))
    got = sharding.param_specs(cfg)
    assert got == want
    leaves = tree_leaves(init_params(cfg, 0, device="cpu"))
    spec_paths = set()
    from qkv_ecc_tpu_torch.models.registry import map_tree
    map_tree(lambda p, s: spec_paths.add(p), got)
    assert spec_paths == set(leaves)
    jc = {k: dim(v) for k, v in j_cache_specs().items()}
    assert sharding.cache_specs() == jc


def test_shard_params_slices():
    """shard_params gives each model index its columns or rows, whole
    tensors elsewhere; shard_cache its KV heads."""
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.parallel.mesh import Mesh

    params = init_params(CFG_TP, 0, device="cpu")
    for i in range(4):
        mesh = Mesh(1, 4, i, torch.device("cpu"))
        p = sharding.shard_params(params, CFG_TP, mesh)
        lp, l0 = p["layers"][0], params["layers"][0]
        assert torch.equal(lp["q_proj"], l0["q_proj"].chunk(4, 1)[i])
        assert torch.equal(lp["o_proj"], l0["o_proj"].chunk(4, 0)[i])
        assert torch.equal(p["lm_head"], params["lm_head"].chunk(4, 1)[i])
        assert p["embed"] is params["embed"]
    state, _, _ = tr.init_generation_state(CFG_TP, policy_for_mode("int12-golay"), 2, 32, 16,
                                           device="cpu")
    state["k_cache"].random_(0, 2 ** 20)
    sh = sharding.shard_cache(state, Mesh(1, 2, 1, torch.device("cpu")))
    assert torch.equal(sh["k_cache"], state["k_cache"][:, :, 2:])
    assert torch.equal(sh["context_len"], state["context_len"])


def test_create_mesh_without_a_group():
    """Without a process group: JAX's defaults on a world of one, its error
    past it, and the 1x1 mesh."""
    from qkv_ecc_tpu_torch.parallel.mesh import single_device_mesh

    assert create_mesh(device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        create_mesh(3, 3, device="cpu")
    m = single_device_mesh("cpu")
    assert m.shape == {"data": 1, "model": 1} and m.model_group is None


def test_make_tp_functions_errors():
    from qkv_ecc_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(NotImplementedError):
        make_tp_functions(dataclasses.replace(TINY_LLAMA, arch="mamba"),
                          policy_for_mode("int4"), Mesh(1, 4, 0, torch.device("cpu")))
    with pytest.raises(AssertionError):  # 8 > 4 KV heads
        make_tp_functions(CFG_TP, policy_for_mode("int4"), Mesh(1, 8, 0, torch.device("cpu")))


def test_single_rank_mesh_is_the_runtime():
    """On a 1x1 mesh without a group, the TP functions are the runtime's:
    generate_tp equals generate at BER 1e-2, on the CPU (no launch)."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend, write_decode_attend)
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.parallel.mesh import single_device_mesh

    params = init_params(CFG_TP, 0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, PROMPT)))
    before = (paged_attention_ecc_write_attend.launches, write_decode_attend.launches,
              paged_attention_ecc.launches)
    for mode in ("int4-hamming84", "int12-golay", "fp16"):
        pol = policy_for_mode(mode, BER, seed=9)
        want = tr.generate(params, ids, CFG_TP, pol, max_new_tokens=4, block_size=BS,
                           device="cpu")
        got = generate_tp(params, ids, CFG_TP, pol, single_device_mesh("cpu"),
                          max_new_tokens=4, block_size=BS)
        assert torch.equal(got, want), mode
    assert (paged_attention_ecc_write_attend.launches, write_decode_attend.launches,
            paged_attention_ecc.launches) == before
