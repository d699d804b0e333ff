"""The port's training (qkv_ecc_tpu_torch.training: trainer, corpus; the
train_tiny CLI) against the JAX package on the same inputs: JAX's init
parameters carried across (params_from_jax), ids and batches from numpy
seeds, JAX's optax chain and its jax.grad.

F12: the fp16 codec's roundtrip (kernels/common.py to_bf16, reached from
kv_policy.encode_kv) rounded through integer bits, so autograd saw no path
from the loss to K and V: tiny-llama's k_proj and v_proj got no gradient,
and everything below the last layer's attention got a wrong one.
test_f12_gradients_match_jax fails on that code.

Tolerances, with their reasons:
  * gradients of the fp16 loss: each leaf within 1e-3 of its largest |g|
    from jax.grad. The cast to bfloat16 rounds the cotangent of K and V to
    bfloat16 in both (JAX's astype, torch's .to), and a float32 difference
    of an ulp between XLA's and torch's matmuls can land a cotangent on the
    neighbouring bfloat16 value (2^-8 relative); measured: 1.8e-4 of the
    largest |g| (tiny-gpt2's c_attn bias), 3.2e-6 on tiny-llama;
  * the schedule: optax's float32 values within 1e-6 relative (np.cos and
    XLA's cos may differ by an ulp; most counts are equal bit for bit);
  * the clip against optax: 1e-6 relative (float32 sums in another
    order); AdamW's parameters after 8 updates of about lr 1e-2 each
    within 1e-6 (optax and torch order the update's float32 operations
    otherwise; measured 2.2e-7);
  * train_tiny against JAX's over 12 steps: the logged losses within 2e-5,
    every parameter within 2e-5, but the K third of gpt2's c_attn bias
    within the sum of the learning rates: its gradient is 0 in exact
    arithmetic (softmax ignores a shift of every key), so Adam's step there
    is lr times the sign of each package's rounding noise (measured: 4.4e-4
    there, 9.3e-7 on every other parameter; losses within 3.3e-6);
  * checkpoints, the corpus, the tokenizer: equal.
"""

import dataclasses
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.models import config as jconfig  # noqa: E402
from qkv_ecc_tpu.models import kv_policy as jkv  # noqa: E402
from qkv_ecc_tpu.models import registry as jreg  # noqa: E402
from qkv_ecc_tpu.training import corpus as jcorpus  # noqa: E402
from qkv_ecc_tpu.training import trainer as jtrainer  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.data import synthetic_corpus  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import train_tiny as tcli  # noqa: E402
from qkv_ecc_tpu_torch.models import config as tconfig  # noqa: E402
from qkv_ecc_tpu_torch.models import kv_policy as tkv  # noqa: E402
from qkv_ecc_tpu_torch.models import registry as treg  # noqa: E402
from qkv_ecc_tpu_torch.training import corpus as tcorpus  # noqa: E402
from qkv_ecc_tpu_torch.training import trainer as ttrainer  # noqa: E402

torch.set_num_threads(1)
MODELS = ["tiny-gpt2", "tiny-llama"]
CORPUS = " ".join(synthetic_corpus(40)).encode()


def jax_leaves(tree):
    """{tree path: numpy array} of a JAX pytree, keyed as save_params keys."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in torch_leaves(sub, path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in torch_leaves(sub, path + (str(i),)).items()}
    return {"/".join(path): tree}


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    jc, tc = jconfig.get_model_config(request.param), tconfig.get_model_config(request.param)
    jp = jreg.init_params(jc, 0)
    return jc, tc, jp


def from_jax(jp, tc):
    return treg.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def test_f12_gradients_match_jax(model):
    """Every leaf's gradient of the fp16 training loss against jax.grad of
    JAX's on the same parameters and ids (the trainer's loss: the forward
    of ids[:, :-1], the mean next-token cross entropy)."""
    jc, tc, jp = model
    chunk = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 17)).astype(np.int32)

    def jax_loss(p):
        ids = jnp.asarray(chunk[:, :-1])
        logits, _ = jreg.forward(p, ids, jc, jkv.KVCachePolicy(codec="fp16"))
        total, count = jreg.cross_entropy(logits, ids)
        return total / jnp.maximum(count, 1)

    want_loss, want = jax.value_and_grad(jax_loss)(jp)
    tp = from_jax(jp, tc)
    for leaf in torch_leaves(tp).values():
        leaf.requires_grad_(True)
    loss = ttrainer.train_loss(tp, torch.from_numpy(chunk), tc, tkv.KVCachePolicy(codec="fp16"))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    want = jax_leaves(want)
    for key, leaf in torch_leaves(tp).items():
        assert leaf.grad is not None, f"{key}: no gradient"
        g, w = leaf.grad.numpy(), want[key]
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), key


def test_fp8_roundtrip_gradient_matches_jax():
    """fp8's codec at BER 0 is a cast to e4m3 and back, which jax.grad
    differentiates (the cotangent rounded to e4m3): the port's carries the
    same gradient, on values inside e4m3's range."""
    x = np.random.default_rng(1).normal(size=(2, 5, 3, 8)).astype(np.float32) * 4
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    pol_j = jkv.KVCachePolicy(codec="fp8")
    want = jax.grad(lambda v: jnp.sum(jkv.kv_roundtrip(v, pol_j, jax.random.key(0))[0] * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = tkv.kv_roundtrip(xt, tkv.KVCachePolicy(codec="fp8"))
    (out * torch.from_numpy(w)).sum().backward()
    assert np.array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("steps,warmup,lr", [(12, 200, 3e-4), (4000, 200, 3e-4), (50, 3, 1e-3),
                                             (20, 5, 0.0)])
def test_schedule_matches_optax(steps, warmup, lr):
    """optax.warmup_cosine_decay_schedule(0, lr, w, steps, 0.1 lr) with
    JAX's w = min(warmup, max(steps // 10, 1)), at every count (count 0 is
    the first update's, whose rate is 0), and beyond the last."""
    w = min(warmup, max(steps // 10, 1))
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, w, steps, lr * 0.1)
    mine = ttrainer.warmup_cosine_schedule(ttrainer.TrainConfig(steps=steps, warmup=warmup, lr=lr))
    counts = list(range(min(steps, 300) + 3)) + [steps - 1, steps, steps + 7]
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts, jnp.int32)))
    got = np.asarray([mine(c) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0


def test_schedule_raises_where_optax_does():
    """One step leaves no step after the warmup: optax refuses it, so does
    the port."""
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 3e-4, 1, 1, 3e-5)
    with pytest.raises(ValueError):
        ttrainer.warmup_cosine_schedule(ttrainer.TrainConfig(steps=1))


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_matches_optax(scale):
    """optax.clip_by_global_norm(1.0): gradients below the norm are left
    alone, those above divided by the norm then multiplied by it."""
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((7, 5), (11,), (3, 2, 4))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttrainer.clip_by_global_norm_(got, 1.0)
    assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if scale < 1:
            assert np.array_equal(g.numpy(), orig)


def test_adamw_matches_optax():
    """torch.optim.AdamW (betas 0.9, 0.999, eps 1e-8, decay 0.01, one
    parameter group, the rate set each step) is optax.adamw on the
    schedule: the same parameters after 8 updates of the same gradients."""
    rng = np.random.default_rng(4)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((6, 4), (9,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in p0] for _ in range(8)]
    tcfg = ttrainer.TrainConfig(steps=8, lr=1e-2)
    schedule = ttrainer.warmup_cosine_schedule(tcfg)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 8, 1e-3),
                     weight_decay=0.01)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    opt = torch.optim.AdamW(tp, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for step, gs in enumerate(grads):
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = schedule(step)
        opt.step()
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_train_tiny_matches_jax(model):
    """12 steps of train_tiny from JAX's init (the port given it through
    params=) on a fixed byte corpus, batches from the same default_rng(0):
    every logged loss and every parameter against JAX's optax trainer."""
    jc, tc, jp = model
    tcfg = jtrainer.TrainConfig(steps=12, batch=4, seq_len=32, log_every=1)
    jlog, tlog = [], []
    want, want_loss = jtrainer.train_tiny(jc, CORPUS, tcfg, lambda s, l, e: jlog.append((s, l)))
    got, got_loss = ttrainer.train_tiny(
        tc, CORPUS, ttrainer.TrainConfig(**dataclasses.asdict(tcfg)),
        lambda s, l, e: tlog.append((s, l)), params=from_jax(jp, tc), device="cpu")
    assert [s for s, _ in tlog] == [s for s, _ in jlog] == list(range(12))
    np.testing.assert_allclose([l for _, l in tlog], [l for _, l in jlog], rtol=0, atol=2e-5)
    assert got_loss == tlog[-1][1]
    want, got = jax_leaves(want), torch_leaves(got)
    assert got.keys() == want.keys()
    E = tc.hidden_size
    lr_sum = sum(ttrainer.warmup_cosine_schedule(ttrainer.TrainConfig(**dataclasses.asdict(
        tcfg)))(c) for c in range(12))
    for key, t in got.items():
        assert t.dtype == torch.float32 and not t.requires_grad
        d = np.abs(t.numpy() - want[key])
        if tc.arch == "gpt2" and key.endswith("c_attn/b"):
            assert d[E:2 * E].max() <= lr_sum, key
            d = np.concatenate([d[:E], d[2 * E:]])
        assert d.max() <= 2e-5, key


def test_checkpoints_load_across_packages(tmp_path):
    """save_params writes JAX's keys, arrays and config JSON: the port's
    checkpoint loads in JAX's load_params and JAX's in the port's, equal."""
    jc, tc = jconfig.get_model_config("tiny-llama"), tconfig.get_model_config("tiny-llama")
    jp = jreg.init_params(jc, 3)
    tp = treg.init_params(tc, 5, device="cpu")
    jtrainer.save_params(jp, str(tmp_path / "j.npz"), jc)
    ttrainer.save_params(tp, str(tmp_path / "t.npz"), tc)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    assert (tmp_path / "t.npz.json").read_text() == (tmp_path / "j.npz.json").read_text()
    back = jax_leaves(jtrainer.load_params(str(tmp_path / "t.npz"), jc))
    for key, t in torch_leaves(tp).items():
        assert np.array_equal(back[key], t.numpy()), key
    back = torch_leaves(ttrainer.load_params(str(tmp_path / "j.npz"), tc, device="cpu"))
    for key, a in jax_leaves(jp).items():
        assert np.array_equal(back[key].numpy(), a), key


def test_build_corpus_matches_jax():
    """build_corpus on this machine's installed libraries: the same
    training bytes and held-out texts as JAX's."""
    want = jcorpus.build_corpus(max_bytes=1 << 20)
    got = tcorpus.build_corpus(max_bytes=1 << 20)
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[1]) == 20 and len(got[0]) > 1 << 20


def test_word_tokenizer_train_and_save_match_jax(tmp_path):
    """WordTokenizer.train (frequency ranks, ties by first appearance,
    <pad> 0 and <unk> 1) and save: JAX's vocabulary, file and ids."""
    text = "\n".join(synthetic_corpus(30)) + "\nrare words here and there\n"
    for size in (40, 8192):
        want = jcorpus.WordTokenizer.train(text, vocab_size=size)
        got = tcorpus.WordTokenizer.train(text, vocab_size=size)
        assert list(got.vocab.items()) == list(want.vocab.items())
        assert got.vocab_size == want.vocab_size
        assert got.encode(text) == want.encode(text)
        want.save(str(tmp_path / "j.json"))
        got.save(str(tmp_path / "t.json"))
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_train_cli_writes_under_runs(tmp_path, monkeypatch):
    """The CLI on the CPU (--device cpu): by default the checkpoint, its
    config's JSON and the held-out texts go under runs/<model>/, never into
    results/; they load back through load_params, and the texts are
    build_corpus's."""
    monkeypatch.chdir(tmp_path)
    res = tcli.main(["--steps", "2", "--batch", "2", "--seq-len", "16", "--max-corpus-mb", "1",
                     "--device", "cpu"])
    out = tmp_path / "runs" / "trained_tiny" / "checkpoint.npz"
    assert res["output"] == "runs/trained_tiny/checkpoint.npz" and out.exists()
    assert not (tmp_path / "results").exists()
    cfg = tconfig.get_model_config("trained-tiny")
    params = ttrainer.load_params(str(out), cfg, device="cpu")
    assert params["wte"].shape == (256, 256)
    assert json.loads((tmp_path / "runs/trained_tiny/checkpoint.npz.json").read_text()) == \
        dataclasses.asdict(jconfig.get_model_config("trained-tiny"))
    texts = json.loads((tmp_path / "runs/trained_tiny/checkpoint.npz.eval_texts.json").read_text())
    assert texts == tcorpus.build_corpus(max_bytes=1 << 20)[1]
    assert [s for s, _, _ in res["log"]] == [0, 1] and np.isfinite(res["final_loss"])
