"""Parity of the port's tiered entity store (photon_ml_tpu_torch/store/
cold.py and entity.py) with the JAX package's, on the CPU in float64.

The JAX side (serving_jax_side.py store, one subprocess per module) runs
the request sequence STORE_OPS on its TieredEntityStore; the port runs the
same sequence: every lane, staged value, hot-table snapshot, counter and
residency field equal after every step (the sampled-LFU victims come from
the same `default_rng(0)` stream).  The cold tier's segments are
byte-compatible: a store either package created opens in the other.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import serving_jax_side as sj
from photon_ml_tpu_torch.store import (ColdStore, ColdStoreError, StoreConfig,
                                       StoreError, TieredEntityStore,
                                       store_totals)
from photon_ml_tpu_torch.store.entity import scatter_rows


def host(t):
    return t.detach().cpu().numpy()


def new_store(directory, config=None, **kw):
    table, ids = sj.store_table()
    return TieredEntityStore.create(
        str(directory), table, StoreConfig(**(config or sj.STORE_TABLE_CONFIG)),
        entity_ids=ids, device="cpu", **kw)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    root = tmp_path_factory.mktemp("store_parity")
    new_store(root / "port_store")            # the JAX side opens this one
    jax = sj.run_jax_side("store", root)
    st = new_store(root / "port_run")
    st.warmup()
    port = sj.run_store_ops(st, host)
    port["full_table"] = st.full_table()
    return root, port, jax


def test_every_step_matches_jax(sides):
    _, port, jax = sides
    keys = {k for k in jax if k[0].isdigit()} | {"table", "full_table"}
    assert keys <= set(port)
    for key in sorted(keys):
        assert np.array_equal(port[key], jax[key]), key
    # the sequence exercised every tier and movement
    last = dict(jax[f"{len(sj.store_ops()) - 1}/stats"].tolist())
    for field in ("hot_hits", "warm_hits", "cold_misses", "promotions",
                  "spills", "evictions", "fetches"):
        assert last[field] > 0, field


def test_cold_segments_open_across_packages(sides):
    root, _, jax = sides
    table, ids = sj.store_table()
    # the JAX package read the port's segments and seals
    assert np.array_equal(jax["port_store/table"], table)
    assert jax["port_store/ids"].tolist() == ids.tolist()
    assert np.array_equal(jax["port_store/gather"], table[:9])
    # the port reads the JAX package's (flushed) store
    cold = ColdStore.open(str(root / "jax_store"))
    assert np.array_equal(cold.read_table(), jax["full_table"])
    assert cold.seal_report() == ColdStore.open(
        str(root / "port_run")).seal_report()
    reopened = TieredEntityStore.open(str(root / "jax_store"), device="cpu")
    rows = reopened.resolve(ids[:9])
    assert np.array_equal(reopened.gather_rows(rows), jax["full_table"][rows])
    port = TieredEntityStore.open(str(root / "port_store"), device="cpu")
    assert np.array_equal(port.gather_rows(port.resolve(ids[:9])),
                          jax["port_store/gather"])


def test_a_torn_segment_is_refused(tmp_path):
    st = new_store(tmp_path / "s")
    seg = tmp_path / "s" / "seg-00002.bin"
    raw = bytearray(seg.read_bytes())
    raw[3] ^= 0xFF
    seg.write_bytes(bytes(raw))
    cold = ColdStore.open(str(tmp_path / "s"))
    with pytest.raises(ColdStoreError, match="sha256"):
        cold.read_segment(2)
    with pytest.raises(StoreError):
        st.gather_rows(np.arange(16, 24))


def test_preload_all_serves_the_same_bytes(tmp_path):
    table, ids = sj.store_table()
    full = new_store(tmp_path / "full", dict(sj.STORE_TABLE_CONFIG,
                                             hot_rows=sj.STORE_ROWS))
    full.preload_all()
    assert torch.equal(full.table(), torch.from_numpy(table))
    slots, stage, snap, values = full.lookup_slots(full.resolve(ids[:5]))
    assert (stage == -1).all() and len(values) == 0
    assert np.array_equal(host(snap)[slots], table[full.resolve(ids[:5])])
    budget = new_store(tmp_path / "budget")
    with pytest.raises(StoreError, match="preload_all"):
        budget.preload_all()
    assert budget.promote_pending() == 0


def test_scatters_write_a_copy(tmp_path):
    """A promotion or write-through replaces the hot table: a snapshot an
    in-flight batch holds never changes."""
    st = new_store(tmp_path / "s", dict(sj.STORE_TABLE_CONFIG, flush_rows=1))
    _, ids = sj.store_table()
    _, _, before, _ = st.lookup_slots(st.resolve(ids[:3]))
    frozen = before.clone()
    st.lookup_slots(st.resolve(ids[3:6]))
    st.update_rows(st.resolve(ids[:3]), np.ones((3, sj.STORE_DIM)))
    assert st.table() is not before and torch.equal(before, frozen)
    t = torch.zeros(4, 2, dtype=torch.float32)
    out = scatter_rows(t, np.asarray([2]), np.asarray([[1.5, 2.5]]))
    assert out.dtype == torch.float32 and t.abs().sum() == 0
    assert out[2].tolist() == [1.5, 2.5]


def test_store_refuses_what_it_cannot_hold(tmp_path):
    st = new_store(tmp_path / "s", dict(sj.STORE_TABLE_CONFIG, overlay_rows=2))
    _, ids = sj.store_table()
    with pytest.raises(StoreError, match="overlay"):
        st.lookup_slots(st.resolve(ids[:5]))
    with pytest.raises(ValueError, match="out of range"):
        st.update_rows(np.asarray([sj.STORE_ROWS]), np.zeros((1, sj.STORE_DIM)))
    with pytest.raises(ValueError, match=">= 1"):
        StoreConfig(hot_rows=0)
    assert store_totals({"a": st})["hot_hits"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TieredEntityStore.open(str(tmp_path / "s"))


def test_identity_ids_need_no_map(tmp_path):
    table = np.arange(12.0).reshape(6, 2)
    st = TieredEntityStore.create(str(tmp_path / "i"), table,
                                  StoreConfig(hot_rows=2, seg_rows=4),
                                  entity_ids=np.arange(6), device="cpu")
    assert st.cold.entity_ids is None
    assert st.resolve(np.asarray([0, 5, 6, -1])).tolist() == [0, 5, -1, -1]
    assert st.resolve(np.asarray(["0", "x"], dtype=object)).tolist() == [-1, -1]
    assert Path(tmp_path / "i" / "meta.json").exists()
