"""The port's multi-process paths on the CPU: the multihost demo CLI
(python -m qkv_ecc_tpu_torch.parallel.multihost) on two gloo processes, and
the scaling harness's mesh tier (benchmarks.scaling.measure_tp_mesh), which
spawns its own ranks.

As the JAX package's tests/test_multihost.py:50-130: every process prints
the same TOKENS (greedy generate_tp) or REQ lines (the multi-host server),
on the demo's tiny-llama with JAX's init (passed as an .npz), in
int12-golay at BER 1e-2: equal to the port's single-process generate and
server on the same draws. The two packages draw different flips (torch's
generator, JAX's threefry), so the JAX comparisons are where the flips
cannot matter: TOKENS at BER 0 against JAX's generate, and the REQ lines at
BER 1e-2 against JAX's server, whose tokens no uncorrectable codeword of
either package's draws changes on these inputs (at BER 1e-2 the generate
run's last token of row 1 does differ: one of them is hit). The serve run
puts the two processes on the data axis (data 2 x model 1), the tokens run
on the model axis (1 x 2).

JAX's in-process TP server is held to the REQ lines too, on a 1x2 mesh; that
test is marked slow (23 s of JAX compilation on this CPU). On a 2x2 mesh
JAX's own TP server disagrees with its single-device server even at BER 0
(its data-parallel admission; ROADMAP.md §3), so the port is held to the
single-device server's semantics.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qkv_ecc_tpu_torch.models import runtime as tr
from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
from qkv_ecc_tpu_torch.models.registry import params_from_jax
from qkv_ecc_tpu_torch.parallel.launch import free_port
from qkv_ecc_tpu_torch.parallel.multihost import demo_config, serve_demo_requests
from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer
from qkv_ecc_tpu_torch.training import save_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = 6


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's init of the demo model, as JAX params and as the port's .npz."""
    jax = _jax()
    from qkv_ecc_tpu.models.config import TINY_LLAMA as J_TINY
    from qkv_ecc_tpu.models.registry import init_params as j_init

    jcfg = dataclasses.replace(J_TINY, name="multihost-demo")
    jparams = j_init(jcfg, 0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), demo_config(), device="cpu")
    path = str(tmp_path_factory.mktemp("demo") / "params.npz")
    save_params(params, path)
    return jcfg, jparams, params, path


def run_demo(path, *extra):
    """The CLI on 2 processes; each one's output."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "qkv_ecc_tpu_torch.parallel.multihost", "--coordinator",
         f"localhost:{port}", "--num-processes", "2", "--process-id", str(i), "--device", "cpu",
         "--params", path, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        outs.append(out)
    return outs


def lines(out, prefix):
    return [line for line in out.splitlines() if line.startswith(prefix)]


@pytest.fixture(scope="module")
def served(weights):
    _, _, _, path = weights
    outs = run_demo(path, "--serve", "--model-axis", "1")
    streams = [lines(o, "REQ ") for o in outs]
    assert all(len(s) == 4 for s in streams), outs[0][-3000:]
    assert "mesh data=2 model=1" in outs[0]
    return streams


def parse_req(stream):
    return {int(line.split()[1]): [int(t) for t in line.split()[2].split(",")]
            for line in stream}


def tokens(path, *extra):
    outs = run_demo(path, "--model-axis", "2", *extra)
    toks = [lines(o, "TOKENS ") for o in outs]
    assert toks[0] and toks[0] == toks[1], outs[0][-3000:]
    assert "mesh data=1 model=2" in outs[0]
    return [int(t) for t in toks[0][0].split(" ", 1)[1].split(",")]


def test_two_process_generation_matches(weights):
    """Both processes print the same TOKENS: at BER 1e-2 the port's
    single-process generate's on the same draws, at BER 0 JAX's."""
    jcfg, jparams, params, path = weights
    prompt = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 9))
    pol = policy_for_mode("int12-golay", ber=1e-2, seed=42)
    own = tr.generate(params, torch.from_numpy(prompt), demo_config(), pol, max_new_tokens=NEW,
                      block_size=16, device="cpu")
    assert tokens(path) == own.reshape(-1).tolist()

    _jax()
    import jax.numpy as jnp
    from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy
    from qkv_ecc_tpu.models.runtime import generate as j_generate

    want = np.asarray(j_generate(jparams, jnp.asarray(prompt), jcfg,
                                 j_policy("int12-golay", ber=0.0, seed=42),
                                 max_new_tokens=NEW, block_size=16))
    assert tokens(path, "--ber", "0") == want.reshape(-1).tolist()


def test_two_process_serving_matches(weights, served):
    """Both processes print the same REQ lines, those of the port's
    single-device server on the same draws and of JAX's single-device
    server."""
    jcfg, jparams, params, _ = weights
    assert served[0] == served[1]
    got = parse_req(served[0])
    server = ContinuousBatchingServer(params, demo_config(),
                                      policy_for_mode("int12-golay", ber=1e-2, seed=42),
                                      max_batch=2, max_seq_len=64, block_size=16,
                                      prefill_bucket=16, device="cpu")
    for req in serve_demo_requests(jcfg.vocab_size):
        server.add_request(req)
    assert got == {o.request_id: list(o.token_ids) for o in server.run()}

    _jax()
    from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy
    from qkv_ecc_tpu.parallel.multihost import serve_demo_requests as j_requests
    from qkv_ecc_tpu.serving import ContinuousBatchingServer as JServer

    jserver = JServer(jparams, jcfg, j_policy("int12-golay", ber=1e-2, seed=42), max_batch=2,
                      max_seq_len=64, block_size=16, prefill_bucket=16)
    for req in j_requests(jcfg.vocab_size):
        jserver.add_request(req)
    assert got == {o.request_id: [int(t) for t in o.token_ids] for o in jserver.run()}


@pytest.mark.slow
def test_two_process_serving_matches_jax_tp_server(weights, served):
    """JAX's in-process TP server on a 1x2 mesh gives the same REQ lines
    (slow: its shard_map compiles take about 23 s on the CPU)."""
    jax = _jax()
    from jax.sharding import Mesh
    from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy
    from qkv_ecc_tpu.parallel.multihost import serve_demo_requests as j_requests
    from qkv_ecc_tpu.serving import TPContinuousBatchingServer as JTPServer

    jcfg, jparams, _, _ = weights
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    server = JTPServer(jparams, jcfg, j_policy("int12-golay", ber=1e-2, seed=42), mesh,
                       max_batch=2, max_seq_len=64, block_size=16, prefill_bucket=16)
    for req in j_requests(jcfg.vocab_size):
        server.add_request(req)
    want = {o.request_id: [int(t) for t in o.token_ids] for o in server.run()}
    assert parse_req(served[0]) == want


def test_measure_tp_mesh_and_efficiency():
    """measure_tp_mesh spawns a 1x2 mesh on the CPU and reports a sane
    row; scaling_efficiency annotates the mesh rows as JAX's."""
    from qkv_ecc_tpu_torch.benchmarks.scaling import measure_tp_mesh, scaling_efficiency
    from qkv_ecc_tpu_torch.models.config import TINY_LLAMA

    policy = policy_for_mode("int4-hamming84", ber=1e-2, seed=42)
    row = measure_tp_mesh(TINY_LLAMA, policy, data=1, model=2, batch_per_data=2, prompt_len=32,
                          steps=3, block_size=16, warmup=1, device="cpu")
    assert row["mesh"] == "1x2" and row["batch"] == 2 and row["tokens_per_s"] > 0
    rows = scaling_efficiency([row, dict(row, mesh="2x2", batch=4,
                                         tokens_per_s=row["tokens_per_s"] * 1.5),
                               {"tier": "single-device", "mesh": "1", "tokens_per_s": 1.0}])
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert rows[1]["weak_scaling_efficiency"] == pytest.approx(0.75)
    assert "weak_scaling_efficiency" not in rows[2]


def test_scaling_cli_default_meshes_as_jax():
    """--meshes defaults to JAX's list; a mesh needing more cards than the
    machine has raises, as JAX's _mesh does."""
    import inspect

    from qkv_ecc_tpu_torch.benchmarks import scaling

    assert 'default="1x1,2x1,4x1,8x1,1x2,2x2"' in inspect.getsource(scaling.main)
    with pytest.raises((ValueError, RuntimeError)):
        scaling._mesh_device(2, 1, None)
