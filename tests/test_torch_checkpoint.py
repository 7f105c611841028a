"""Crash-safe checkpoints and resume in the port (core/checkpoint.py,
``fit(checkpoint_dir=...)``), on the CPU. Mirrors the JAX package's
tests/test_data_checkpoint.py, tests/test_faults.py and the inference
restore of tests/test_model.py, with dropout in every trained model, so
the resumed key stream is what is compared: a resumed run equals the
uninterrupted one bit for bit (tolerance 0). A kill at any fault site
(``ckpt.commit``, ``ckpt.swap``, ``loader.commit``, ``train.dispatch``)
leaves no truncated checkpoint visible."""

import json
import os

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.config import CompMode
from flexflow_tpu_torch.core.checkpoint import (restore_checkpoint,
                                                restore_model,
                                                save_checkpoint, save_model)
from flexflow_tpu_torch.core.dataloader import DataLoaderSet
from flexflow_tpu_torch.utils import faults
from flexflow_tpu_torch.utils.faults import SimulatedKill


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU computations here run at test shapes, and beside
    other test workers on one host each worker's intra-op thread pool
    oversubscribes the cores (a serving case that takes 2 s alone took
    25 s beside two other workers). One thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ckpt_model(seed=0, bs=16, mode=CompMode.TRAINING, dropout=0.25):
    ff = ft.FFModel(ft.FFConfig(batch_size=bs, seed=seed), device="cpu")
    x = ff.create_tensor((bs, 32), name="input")
    t = ff.dense(x, 64, activation="relu", name="dense")
    if dropout:
        t = ff.dropout(t, dropout)
    ff.softmax(ff.dense(t, 4, name="head"))
    ff.compile(optimizer=ft.AdamOptimizer(lr=0.01),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy"], comp_mode=mode)
    return ff


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


def _same_weights(a, b):
    for op in ("dense", "head"):
        wa, wb = a.get_weights(op), b.get_weights(op)
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


def _epochs(ckdir):
    return sorted(d for d in os.listdir(ckdir)
                  if d.startswith("epoch_") and d[len("epoch_"):].isdigit())


def test_checkpoint_save_restore_roundtrip(tmp_path):
    ff = _ckpt_model(bs=32)
    x, y = _data(32)
    for _ in range(3):
        ff.train_batch({"input": x, "label": y})
    path = str(tmp_path / "ckpt")
    save_model(ff, path)
    assert os.listdir(path) == ["state.pt"]
    w_before = ff.get_weights("dense")["kernel"].copy()
    ptr = ff.state.params["dense"]["kernel"].data_ptr()
    for _ in range(3):
        ff.train_batch({"input": x, "label": y})
    assert not np.allclose(ff.get_weights("dense")["kernel"], w_before)
    restore_model(ff, path)
    np.testing.assert_array_equal(ff.get_weights("dense")["kernel"],
                                  w_before)
    # restored in place: a captured step keeps reading the same memory
    assert ff.state.params["dense"]["kernel"].data_ptr() == ptr
    assert ff.state.step == 3 and ff._host_step == 3
    assert np.isfinite(float(ff.train_batch({"input": x,
                                             "label": y})["loss"]))


def test_fit_checkpoint_resume_matches_uninterrupted(tmp_path):
    x, y = _data(64)
    ckdir = str(tmp_path / "ck")
    ff_ref = _ckpt_model()
    h_ref = ff_ref.fit({"input": x}, y, epochs=4, verbose=False)
    _ckpt_model().fit({"input": x}, y, epochs=2, verbose=False,
                      checkpoint_dir=ckdir)
    ff_b = _ckpt_model()
    h_b = ff_b.fit({"input": x}, y, epochs=4, verbose=False,
                   checkpoint_dir=ckdir)
    assert [m["epoch"] for m in h_b] == [2, 3]
    assert [m["loss"] for m in h_b] == [m["loss"] for m in h_ref[2:]]
    _same_weights(ff_ref, ff_b)


def test_fit_checkpoint_noop_when_complete(tmp_path):
    x, y = _data(32)
    ckdir = str(tmp_path / "ck")
    _ckpt_model().fit({"input": x}, y, epochs=2, verbose=False,
                      checkpoint_dir=ckdir)
    assert _epochs(ckdir) == ["epoch_0", "epoch_1"]
    h = _ckpt_model().fit({"input": x}, y, epochs=2, verbose=False,
                          checkpoint_dir=ckdir)
    assert h == []


def test_fit_checkpoint_same_object_continuation(tmp_path):
    """A second fit on the SAME model does not double-advance the
    shuffle stream."""
    x, y = _data(64)
    ff_ref = _ckpt_model()
    h_ref = ff_ref.fit({"input": x}, y, epochs=4, verbose=False)
    ckdir = str(tmp_path / "ck")
    ff = _ckpt_model()
    ff.fit({"input": x}, y, epochs=2, verbose=False, checkpoint_dir=ckdir)
    h2 = ff.fit({"input": x}, y, epochs=4, verbose=False,
                checkpoint_dir=ckdir)
    assert [m["epoch"] for m in h2] == [2, 3]
    assert h2[-1]["loss"] == h_ref[-1]["loss"]
    _same_weights(ff_ref, ff)


def test_restore_model_resyncs_train_rng(tmp_path):
    x, y = _data(16)
    batch = {"input": x, "label": y}
    ff = _ckpt_model()
    for _ in range(3):
        ff.train_batch(batch)
    save_model(ff, str(tmp_path / "m"))
    ff2 = _ckpt_model()
    restore_model(ff2, str(tmp_path / "m"))
    assert ff2._host_step == 3
    for _ in range(2):
        assert float(ff.train_batch(batch)["loss"]) == \
            float(ff2.train_batch(batch)["loss"])
    _same_weights(ff, ff2)


def test_kill_mid_checkpoint_resume_bit_exact(tmp_path):
    """A kill while committing epoch 1 leaves only epoch_0 visible; the
    rerun resumes at epoch 1 and lands where the uninterrupted run
    does."""
    x, y = _data(32)
    ckdir = str(tmp_path / "ck")
    ff_ref = _ckpt_model()
    h_ref = ff_ref.fit({"input": x}, y, epochs=4, verbose=False)
    with faults.active("ckpt.commit:kill@2+"):
        with pytest.raises(SimulatedKill):
            _ckpt_model().fit({"input": x}, y, epochs=4, verbose=False,
                              checkpoint_dir=ckdir)
    assert _epochs(ckdir) == ["epoch_0"]
    ff_b = _ckpt_model()
    h_b = ff_b.fit({"input": x}, y, epochs=4, verbose=False,
                   checkpoint_dir=ckdir)
    assert [m["epoch"] for m in h_b] == [1, 2, 3]
    assert [m["loss"] for m in h_b] == [m["loss"] for m in h_ref[1:]]
    _same_weights(ff_ref, ff_b)


@pytest.mark.parametrize("accum", [1, 2])
def test_kill_at_dispatch_resume_bit_exact(tmp_path, accum):
    """The smoke's resume check at CPU size: 2 epochs x 4 dispatches,
    killed at ``train.dispatch`` inside epoch 1, then run again; with
    grad accumulation _host_step mirrors OPTIMIZER steps."""
    x, y = _data(64 * accum)
    ckdir = str(tmp_path / "ck")
    kw = dict(epochs=2, verbose=False, grad_accum_steps=accum)
    ff_ref = _ckpt_model()
    ff_ref.fit({"input": x}, y, **kw)
    with faults.active("train.dispatch:kill@6"):
        with pytest.raises(SimulatedKill):
            _ckpt_model().fit({"input": x}, y, checkpoint_dir=ckdir, **kw)
    assert _epochs(ckdir) == ["epoch_0"]
    ff_b = _ckpt_model()
    h = ff_b.fit({"input": x}, y, checkpoint_dir=ckdir, **kw)
    assert [m["epoch"] for m in h] == [1]
    assert ff_b.state.step == ff_ref.state.step == 8
    _same_weights(ff_ref, ff_b)


def test_sync_save_kill_leaves_previous_checkpoint(tmp_path):
    x, y = _data(16, seed=1)
    batch = {"input": x, "label": y}
    ff = _ckpt_model()
    ff.train_batch(batch)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, ff.state)
    w_old = ff.get_weights("dense")["kernel"].copy()
    ff.train_batch(batch)
    with faults.active("ckpt.commit:kill@1"):
        with pytest.raises(SimulatedKill):
            save_checkpoint(path, ff.state)
    restored = restore_checkpoint(path, ff.state)
    assert restored.step == 1
    np.testing.assert_array_equal(
        restored.params["dense"]["kernel"].detach().numpy(), w_old)
    save_checkpoint(path, ff.state)     # sweeps the stale tmp
    assert restore_checkpoint(path, ff.state).step == 2
    assert not os.path.exists(path + ".tmp")


def test_kill_inside_promote_window_recovers_old(tmp_path):
    x, y = _data(16, seed=3)
    batch = {"input": x, "label": y}
    ff = _ckpt_model()
    ff.train_batch(batch)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, ff.state)
    ff.train_batch(batch)
    with faults.active("ckpt.swap:kill@1"):
        with pytest.raises(SimulatedKill):
            save_checkpoint(path, ff.state)
    assert not os.path.isdir(path)            # the window, frozen
    assert os.path.isdir(path + ".old")
    assert restore_checkpoint(path, ff.state).step == 1   # recovers .old
    assert os.path.isdir(path)


def test_fit_resume_skips_corrupt_newest_epoch(tmp_path):
    x, y = _data(32, seed=2)
    ckdir = tmp_path / "ck"
    _ckpt_model().fit({"input": x}, y, epochs=2, verbose=False,
                      checkpoint_dir=str(ckdir))
    victim = ckdir / "epoch_1"
    for root, _, files in os.walk(victim):
        for f in files:
            open(os.path.join(root, f), "wb").close()     # truncate
    with pytest.warns(UserWarning, match="epoch_1 unreadable"):
        h = _ckpt_model().fit({"input": x}, y, epochs=3, verbose=False,
                              checkpoint_dir=str(ckdir))
    assert [m["epoch"] for m in h] == [1, 2]


def test_restore_refuses_another_graph(tmp_path):
    ff = _ckpt_model()
    save_model(ff, str(tmp_path / "m"))
    other = ft.FFModel(ft.FFConfig(batch_size=16), device="cpu")
    other.dense(other.create_tensor((16, 32), name="input"), 8,
                name="dense")
    other.compile(optimizer=ft.AdamOptimizer())
    with pytest.raises(ValueError, match="checkpoint"):
        restore_model(other, str(tmp_path / "m"))


def test_loader_state_checkpoint_atomic(tmp_path):
    x = np.arange(64, dtype=np.float32).reshape(64, 1)
    y = np.arange(64, dtype=np.int32)
    path = str(tmp_path / "loader.json")
    ds = DataLoaderSet({"input": x, "label": y}, batch_size=16,
                       shuffle=True, seed=3, prefetch=False, device="cpu")
    list(ds)
    ds.save_state(path)
    epoch1 = [b["label"].tolist() for b in ds]
    ds2 = DataLoaderSet({"input": x, "label": y}, batch_size=16,
                        shuffle=True, seed=99, prefetch=False, device="cpu")
    assert ds2.load_state(path)
    assert [b["label"].tolist() for b in ds2] == epoch1
    old = open(path).read()
    with faults.active("loader.commit:kill@1"):
        with pytest.raises(SimulatedKill):
            ds.save_state(path)
    assert open(path).read() == old
    assert not ds2.load_state(str(tmp_path / "absent.json"))
    bad = json.loads(old)
    bad["rng"][2] = "not-an-int"
    badpath = str(tmp_path / "bad.json")
    with open(badpath, "w") as f:
        json.dump(bad, f)
    before = ds2.state_dict()
    assert not ds2.load_state(badpath)
    assert ds2.state_dict()["rng"] == before["rng"]


def test_inference_restores_training_checkpoint(tmp_path):
    """train -> checkpoint -> inference compile -> restore: the slots
    on disk are skipped and the forward matches."""
    x, y = _data(16)
    b = {"input": x, "label": y}
    ff = _ckpt_model()
    ff.train_batch(b)
    save_model(ff, str(tmp_path / "ckpt"))
    fi = _ckpt_model(mode=CompMode.INFERENCE)
    restore_model(fi, str(tmp_path / "ckpt"))
    assert fi.state.step == 1 and fi.state.opt_state == {}
    np.testing.assert_array_equal(fi.forward(b).numpy(),
                                  ff.forward(b).numpy())
