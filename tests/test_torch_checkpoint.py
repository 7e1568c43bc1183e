"""The port's EdgeKV quorum checkpointer and training loop against the JAX
reference: the reference's eight checkpoint cases on the port, the
manifest of the same state saved by both packages, checkpoints crossing
between them, the reference's three training-loop cases on the port on
the CPU (kill-and-resume bitwise), the port's loop following the
reference's losses from the same weights, and the launcher."""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import QuorumCheckpointer as JaxQuorumCheckpointer
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro.train.loop import train_loop as jax_train_loop
from repro_torch.checkpoint import QuorumCheckpointer
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_jax
from repro_torch.train.loop import train_loop

ROOT = Path(__file__).resolve().parents[1]


def tiny_state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": torch.from_numpy(
                       rng.standard_normal((4, 8, 8)).astype(np.float32)),
                   "b": torch.from_numpy(
                       rng.standard_normal((4, 8)).astype(np.float32))},
        "embed": torch.from_numpy(
            rng.standard_normal((16, 8)).astype(np.float32)),
        "count": torch.tensor(7, dtype=torch.int32),
    }


def template(state):
    return {k: template(v) if isinstance(v, dict) else torch.empty_like(v)
            for k, v in state.items()}


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------- the reference's checkpoint cases, ported
def test_save_restore_roundtrip(tmp_path):
    ck = QuorumCheckpointer(str(tmp_path), n_hosts=5, replication=3)
    state = tiny_state()
    ck.save(3, state)
    out = ck.restore(template(state))
    assert_tree_equal(state, out)
    assert ck.latest_step() == 3


def test_restore_survives_minority_host_loss(tmp_path):
    ck = QuorumCheckpointer(str(tmp_path), n_hosts=5, replication=3)
    state = tiny_state(1)
    ck.save(1, state)
    ck.kill_host(0)  # one replica of some shards gone
    assert_tree_equal(state, ck.restore(template(state)))


def test_save_with_dead_host_still_commits(tmp_path):
    ck = QuorumCheckpointer(str(tmp_path), n_hosts=5, replication=3)
    ck.kill_host(2)
    state = tiny_state(2)
    manifest = ck.save(5, state)
    for info in manifest["shards"].values():
        assert len(info["acked"]) >= 2
    assert_tree_equal(state, ck.restore(template(state)))


def test_majority_loss_blocks_save(tmp_path):
    ck = QuorumCheckpointer(str(tmp_path), n_hosts=3, replication=3)
    ck.kill_host(0)
    ck.kill_host(1)
    with pytest.raises(RuntimeError, match="replicas"):
        ck.save(1, tiny_state())


def test_backup_mirror_restore(tmp_path):
    ck = QuorumCheckpointer(str(tmp_path / "pod0"), n_hosts=4,
                            replication=3,
                            mirror_root=str(tmp_path / "pod1"))
    state = tiny_state(3)
    ck.save(9, state)
    ck._mirror_thread.join()
    for h in range(4):
        ck.kill_host(h)
    out = ck.restore(template(state), prefer_backup=True)
    assert_tree_equal(state, out)


def test_elastic_reshard_moves_few_shards(tmp_path):
    ck = QuorumCheckpointer(str(tmp_path), n_hosts=8, replication=3)
    state = {"w" + str(i): torch.ones(4) * i for i in range(64)}
    ck.save(1, state)
    res = ck.reshard(9)  # +1 host
    assert res["moved"] < res["total"] * 0.7
    ck2 = QuorumCheckpointer(str(tmp_path), n_hosts=9, replication=3)
    assert_tree_equal(state, ck2.restore(template(state)))


def test_async_save_overlaps(tmp_path):
    """The snapshot is taken before ``save_async`` returns: an in-place
    update right after it (what the optimizer does) is not saved."""
    ck = QuorumCheckpointer(str(tmp_path), n_hosts=4, replication=3)
    state = {"w": torch.ones((256, 256))}
    want = {"w": state["w"].clone()}
    t = ck.save_async(2, state)
    state["w"].add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    assert_tree_equal(want, ck.restore(template(state)))


def test_checksum_detects_corruption(tmp_path):
    ck = QuorumCheckpointer(str(tmp_path), n_hosts=3, replication=3)
    state = {"w": torch.arange(16.0)}
    m = ck.save(1, state)
    for host in m["shards"]["w"]["acked"]:
        p = tmp_path / host / "step1" / "w.npy"
        arr = np.load(p)
        arr[0] = 999.0
        np.save(p, arr)
    with pytest.raises(RuntimeError, match="no surviving replica"):
        ck.restore(template(state))


# ----------------------------------------- the same state in both packages
@pytest.fixture(scope="module")
def trained_state():
    """Reduced stablelm-3b after two AdamW updates in the reference: its
    state tree, and the same state in the port's layout."""
    jcfg = jax_reduced(jax_get_config("stablelm-3b"))
    cfg = reduced(get_config("stablelm-3b"))
    p = jax_init_params(jcfg, jax.random.PRNGKey(0))
    opt = jax_adamw(1e-3)
    o = opt.init(p)
    rng = np.random.default_rng(0)
    for _ in range(2):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
            a.shape).astype(np.float32)), p)
        p, o = opt.update(g, o, p)
    jstate = jax.tree.map(np.asarray, {"p": p, "o": o})
    tstate = {"p": params_from_jax(jstate["p"]),
              "o": {"m": params_from_jax(jstate["o"]["m"]),
                    "v": params_from_jax(jstate["o"]["v"]),
                    "count": torch.from_numpy(np.array(jstate["o"]["count"]))}}
    return cfg, jstate, tstate


def test_manifest_equals_the_references(tmp_path, trained_state):
    """Keys, replicas, acks, dtypes, shapes and checksums: the port writes
    the reference's layout, so the ring places each shard alike."""
    _, jstate, tstate = trained_state
    jm = JaxQuorumCheckpointer(str(tmp_path / "jax"), 4).save(2, jstate)
    tm = QuorumCheckpointer(str(tmp_path / "torch"), 4).save(2, tstate)
    assert tm == jm
    assert "p/layers/attn/wq" in tm["shards"] and "o/count" in tm["shards"]
    assert tm["shards"]["p/layers/attn/wq"]["shape"][0] == 4   # stacked


def test_checkpoints_cross_between_the_packages(tmp_path, trained_state):
    """A reference checkpoint restores in the port bitwise, with one host
    of four lost, and a port checkpoint restores in the reference."""
    _, jstate, tstate = trained_state
    jck = JaxQuorumCheckpointer(str(tmp_path / "a"), 4)
    jck.save(2, jstate)
    tck = QuorumCheckpointer(str(tmp_path / "a"), 4)
    tck.kill_host(1)
    assert_tree_equal(tstate, tck.restore(template(tstate)))

    QuorumCheckpointer(str(tmp_path / "b"), 4).save(3, tstate)
    back = JaxQuorumCheckpointer(str(tmp_path / "b"), 4).restore(
        jax.eval_shape(lambda: jax.tree.map(jnp.asarray, jstate)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), b)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 5 steps and checkpoints; the port resumes from
    it to step 10 on the CPU and follows the reference's uninterrupted
    run within LOSS_RTOL."""
    jcfg = jax_reduced(jax_get_config("stablelm-3b"))
    cfg = reduced(get_config("stablelm-3b"))
    ref = jax_train_loop(jcfg, steps=10, batch=2, seq_len=32, seed=3)
    ck = JaxQuorumCheckpointer(str(tmp_path / "ck"), n_hosts=4)
    jax_train_loop(jcfg, steps=5, batch=2, seq_len=32, seed=3, ckpt=ck,
                   ckpt_every=100, async_ckpt=False)
    res = train_loop(cfg, steps=10, batch=2, seq_len=32, seed=3,
                     ckpt=QuorumCheckpointer(str(tmp_path / "ck"), 4),
                     ckpt_every=100, async_ckpt=False, device="cpu")
    assert res.restored_from == 5 and res.final_step == 10
    np.testing.assert_allclose(res.losses, ref.losses[5:], rtol=LOSS_RTOL)


# ------------------------ the reference's training-loop cases, on the port
@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("stablelm-3b"))


def test_loss_decreases(cfg):
    res = train_loop(cfg, steps=20, batch=4, seq_len=64, lr=3e-3, seed=1,
                     device="cpu")
    first = np.mean(res.losses[:4])
    last = np.mean(res.losses[-4:])
    assert last < first, (first, last)


def test_preempt_resume_bit_exact(cfg, tmp_path):
    """10 steps straight against 5, a checkpoint, a "crash" and a resume:
    every loss bitwise equal (the reference's own test allows 1e-5)."""
    ref = train_loop(cfg, steps=10, batch=2, seq_len=32, seed=3,
                     device="cpu")
    ck = QuorumCheckpointer(str(tmp_path / "ck"), n_hosts=4, replication=3)
    a = train_loop(cfg, steps=5, batch=2, seq_len=32, seed=3, ckpt=ck,
                   ckpt_every=100, async_ckpt=False, device="cpu")
    assert ck.latest_step() == 5
    b = train_loop(cfg, steps=10, batch=2, seq_len=32, seed=3, ckpt=ck,
                   ckpt_every=100, async_ckpt=False, device="cpu")
    assert b.restored_from == 5
    assert a.losses + b.losses == ref.losses


def test_resume_after_host_loss(cfg, tmp_path):
    ck = QuorumCheckpointer(str(tmp_path / "ck"), n_hosts=5, replication=3)
    train_loop(cfg, steps=3, batch=2, seq_len=32, seed=4, ckpt=ck,
               ckpt_every=100, async_ckpt=False, device="cpu")
    ck.kill_host(1)  # minority of every replica set
    res = train_loop(cfg, steps=6, batch=2, seq_len=32, seed=4, ckpt=ck,
                     ckpt_every=100, async_ckpt=False, device="cpu")
    assert res.restored_from == 3
    assert len(res.losses) == 3


def test_async_checkpoints_resume_bit_exact(cfg, tmp_path):
    """Checkpoints every 2 steps written in the background while the next
    steps update the same tensors in place: a resume from the step-4
    checkpoint replays the straight run's steps 5 and 6 bitwise."""
    ref = train_loop(cfg, steps=6, batch=2, seq_len=32, seed=5,
                     device="cpu")
    root = tmp_path / "ck"
    a = train_loop(cfg, steps=6, batch=2, seq_len=32, seed=5,
                   ckpt=QuorumCheckpointer(str(root), 4), ckpt_every=2,
                   device="cpu")
    assert a.losses == ref.losses
    (root / "manifest-6.json").unlink()       # step 4 is now the latest
    b = train_loop(cfg, steps=6, batch=2, seq_len=32, seed=5,
                   ckpt=QuorumCheckpointer(str(root), 4), device="cpu")
    assert b.restored_from == 4
    assert b.losses == ref.losses[4:]


# -------------------------------------- the port follows the reference
# losses of the port's loop against the reference's from the same weights
# and batches, 10 AdamW steps at lr 3e-4: relative, the float32 sums of
# both compounding over the steps
LOSS_RTOL = 1e-5


def _loaded(cfg, state_dict):
    model = init_params(cfg, 0)
    model.load_state_dict(state_dict, strict=True)
    return model


def test_train_loop_follows_the_reference():
    jcfg = jax_reduced(jax_get_config("stablelm-3b"))
    cfg = reduced(get_config("stablelm-3b"))
    ref = jax_train_loop(jcfg, steps=10, batch=2, seq_len=32, seed=2)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(2)))
    res = train_loop(cfg, steps=10, batch=2, seq_len=32, seed=2,
                     device="cpu", params=_loaded(cfg, params_from_jax(tree)))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=LOSS_RTOL)


def test_train_loop_defaults_to_the_gpu(cfg):
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None, "train_loop").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="GPU"):
        train_loop(cfg, steps=1, batch=1, seq_len=8)
    with pytest.raises(RuntimeError, match="GPU"):
        train_loop(cfg, steps=1, batch=1, seq_len=8, device="cuda")
    with pytest.raises(ValueError, match="params"):
        train_loop(cfg, steps=1, batch=1, seq_len=8, device="cpu",
                   params=init_params(dataclasses.replace(cfg, n_layers=1),
                                      0))


# ---------------------------------------------------------------- the CLI
def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_cli_reduced_on_the_cpu(tmp_path):
    args = ["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq-len", "32",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    out = run_cli(*args)
    assert out[-1] == "done at step 4"
    steps = [int(m.group(1)) for ln in out
             if (m := re.match(r"step (\d+): loss=\d+\.\d{4}$", ln))]
    assert steps == [1, 2, 3, 4]
    manifest = json.loads((tmp_path / "ck" / "manifest-4.json").read_text())
    assert manifest["step"] == 4 and manifest["n_hosts"] == 4
    out = run_cli(*args[:-4], "--steps", "6", "--ckpt-dir",
                  str(tmp_path / "ck"))
    assert out[0] == "resumed from step 4"
    assert out[-1] == "done at step 6"
