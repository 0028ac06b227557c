"""Converters, timers, checkpointing."""

import numpy as np
import jax.numpy as jnp

from graphaibench_tpu.graph.converters import convert, read_gr, read_mtx
from graphaibench_tpu.graph.io import load_graph
from graphaibench_tpu.utils import OpTimers, restore_checkpoint, save_checkpoint


def test_mtx_matches_binary_fixture(tester):
    g = read_mtx("/root/reference/inputs/tester.mtx")
    np.testing.assert_array_equal(g.row_ptr, tester.row_ptr)
    np.testing.assert_array_equal(g.col_idx, tester.col_idx)


def test_read_csgr():
    g = read_gr("/root/reference/inputs/gnn-tester/tester.csgr")
    assert g.nv == 7 and g.ne == 12


def test_convert_pipeline(tmp_path):
    out = str(tmp_path / "conv")
    g = convert("/root/reference/inputs/tester.mtx", out, clean=True)
    g2 = load_graph(out)
    np.testing.assert_array_equal(g2.col_idx, g.col_idx)
    # with orientation: halves the symmetric edge count
    out2 = str(tmp_path / "dag")
    dag = convert("/root/reference/inputs/tester.mtx", out2, orient=True)
    assert dag.ne == g.ne // 2


def test_op_timers(capsys):
    t = OpTimers()
    with t.op("sparse_mm"):
        pass
    t.add("dense_mm", 0.5)
    t.print_timers()
    out = capsys.readouterr().out
    assert "dense_mm" in out and "sparse_mm" in out


def test_checkpoint_roundtrip(tmp_path):
    state = {"w": jnp.arange(6.0).reshape(2, 3), "nested": [jnp.ones(4)]}
    save_checkpoint(str(tmp_path / "ck"), state, step=3)
    like = {"w": jnp.zeros((2, 3)), "nested": [jnp.zeros(4)]}
    restored = restore_checkpoint(str(tmp_path / "ck"), like, step=3)
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.asarray(state["w"]))
    np.testing.assert_array_equal(np.asarray(restored["nested"][0]), 1.0)


def test_csgr_gnn_dataset_end_to_end():
    """Legacy csgr dataset path (reference reader.cpp:16-246): load the
    gnn-tester fixture and train a 2-layer GCN on it."""
    from graphaibench_tpu.graph.io import load_gnn_dataset_csgr
    from graphaibench_tpu.nn import Model, make_config

    ds = load_gnn_dataset_csgr("/root/reference/inputs/gnn-tester")
    assert ds.graph.nv == 7 and ds.feats.shape == (7, 3)
    assert ds.num_classes == 7
    assert ds.train_range == (0, 5, 5)
    cfg = make_config("gcn", 2, ds.feat_len, 8, ds.num_classes)
    m = Model(cfg, ds)
    losses = [m.train_epoch()[0] for _ in range(15)]
    assert losses[-1] < losses[0]


def test_model_checkpoint_resume(tmp_path):
    """Train 3 epochs, checkpoint, train 2 more; a restored model must
    continue bit-identically (same params after the same extra epochs)."""
    import jax

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn import Model, make_config

    g = rmat(7, 8, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.nv, 12)).astype(np.float32)
    labels = rng.integers(0, 4, g.nv).astype(np.int32)
    mask = np.ones(g.nv, np.uint8)
    tr = (0, g.nv, g.nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=tr, val_range=tr, test_range=tr)
    cfg = make_config("gcn", 2, 12, 8, 4)
    m = Model(cfg, ds)
    for _ in range(3):
        m.train_epoch()
    key_at_ckpt = m.key
    m.save(str(tmp_path / "ck"), step=3)
    for _ in range(2):
        m.train_epoch()
    final = jax.tree.map(np.asarray, m.params)

    m2 = Model(cfg, ds)
    m2.restore(str(tmp_path / "ck"), step=3)
    m2.key = key_at_ckpt  # RNG state travels separately (seeded)
    for _ in range(2):
        m2.train_epoch()
    final2 = jax.tree.map(np.asarray, m2.params)
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(final2)):
        np.testing.assert_array_equal(a, b)


def test_timers_wired_into_training(capsys):
    """`cli train ... --timers` prints the stage breakdown with step/eval
    tags accumulated (the reference prints its per-op table on every
    run, train.cpp:60-76); the sampled and sharded
    paths also tag sample/halo respectively."""
    import os

    from graphaibench_tpu import cli
    from graphaibench_tpu.utils.timers import TIMERS

    rc = cli.cmd_train(["gcn", "/root/reference/inputs/cora", "4", "0",
                        "softmax", "16", "0", "0", "0.02", "2", "0", "2",
                        "--timers"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Per-op time breakdown:" in out
    assert TIMERS.counts["step"] == 4
    assert TIMERS.counts["eval"] >= 2   # val at epoch 2 + final test

    # sampled path tags the non-overlapped sampler wait
    rc = cli.cmd_train(["gcn", "/root/reference/inputs/cora", "3", "0",
                        "softmax", "16", "0", "0", "0.02", "2", "512",
                        "50", "--timers"])
    out = capsys.readouterr().out
    assert rc == 0
    assert TIMERS.counts["sample"] == 3 and TIMERS.counts["step"] == 3


def test_timers_sharded_halo(monkeypatch, capsys):
    from graphaibench_tpu import cli
    from graphaibench_tpu.utils.timers import TIMERS

    monkeypatch.setenv("GAB_SHARDS", "4")
    rc = cli.cmd_train(["gcn", "/root/reference/inputs/cora", "3", "0",
                        "softmax", "16", "0", "0", "0.02", "2", "0", "2",
                        "--timers"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Per-op time breakdown:" in out and "halo" in out
    assert TIMERS.counts["step"] == 3 and TIMERS.counts["halo"] == 1
