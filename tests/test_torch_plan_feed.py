"""The eval step's plan feed, on the CPU at test size:

- `data.dataset.collate_fn` keeps a plan that every sample holds as the same
  read-only array as one read-only view with stride 0 on the batch axis, and
  stacks any other mix as before; the values are the JAX collate's;
- `chunk_plans` with a cache, and the dataset's pair plans, give a repeated
  calibration the same read-only arrays;
- `train.loop.DevicePlans` caches exactly a stride-0 view of a read-only
  array that owns its memory, keeps the latest owners, and drops an entry
  when its owner is freed;
- `make_eval_step` moves only the plans its lift reads (the frustum cells
  stay on the host under B2 with chunk plans), counts in ``h2d_bytes`` the
  bytes it copies and in ``plan_hits`` the plans it found on the device, and
  gives the detections of the step that copied everything, bit for bit.
"""

import gc
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plan_feed_helpers as pf
from bevfusion_multimodal_3d_object_detection_tpu.data import dataset as jax_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel.mesh import DataGroup
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling import recorded_spans, span

CPU = torch.device("cpu")


def _read_only(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


def _step(m):
    return port_loop.make_eval_step(m, port_config.CompatFlags(), device="cpu")


def _profiled():
    span("outside")  # found off: the next recording span starts a stretch
    return profile(activities=[ProfilerActivity.CPU])


def _inputs_spans():
    return [s["attrs"] for s in recorded_spans() if s["name"] == "eval.inputs"]


@pytest.fixture(scope="module")
def pallas_model():
    return pf.model("pallas")


@pytest.mark.parametrize("case", ["shared", "mixed", "writable"])
def test_collate_shares_exactly_a_read_only_plan(case):
    gt = dict(gt_boxes=np.zeros((1, 7), np.float32), gt_labels=np.zeros(1, np.int64),
              gt_velocities=np.zeros((1, 2), np.float32), token="t")
    samples = [dict(s, **gt) for s in pf.samples((5, 6, 5, 5) if case == "mixed" else (5,) * 4, cache={})]
    if case == "writable":  # one object in every sample, but writable
        plans = {k: np.array(samples[0][k]) for k in pf.CHUNKS}
        samples = [dict(s, **plans) for s in samples]
    got = port_dataset.collate_fn(samples)
    want = jax_dataset.collate_fn([dict(s) for s in samples])
    assert got.keys() == want.keys() and got.pop("tokens") == want.pop("tokens")
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    shared = case == "shared"
    for k in pf.CHUNKS:
        assert (got[k].strides[0] == 0) is shared and got[k].flags.writeable is not shared
        assert port_loop.DevicePlans.owner(got[k]) is (samples[0][k] if shared else None)
    # the cells are made anew for each sample (writable): stacked
    assert got["camera_cells"].flags.writeable and got["camera_cells"].strides[0] != 0


@pytest.mark.parametrize("kind", ["chunks", "pairs"])
def test_a_repeated_calibration_gets_the_same_read_only_plans(kind):
    if kind == "chunks":
        cache = {}

        def plans_of(cells):
            return port_dataset.chunk_plans(cells, pf.NUM_CELLS, cache)
    else:
        ds = types.SimpleNamespace(bev_h=10, bev_w=10, _cull_caps=(64, 64), _cull_caps_lock=threading.Lock(),
                                   _pair_cache={})
        cache = ds._pair_cache

        def plans_of(cells):
            return port_dataset.NuScenesDataset._pair_plans(ds, cells)

    a, b, again = plans_of(pf.cells(1)), plans_of(pf.cells(2)), plans_of(pf.cells(1))
    assert len(cache) == 2 and a.keys() == again.keys() == b.keys()
    for k in a:
        assert again[k] is a[k] and b[k] is not a[k]
        assert not a[k].flags.writeable and not b[k].flags.writeable and a[k].flags.owndata
        with pytest.raises(ValueError):
            a[k][...] = 0
    a.clear()  # the caller's dict, not the cache's
    assert plans_of(pf.cells(1)).keys() == again.keys()
    if kind == "chunks":  # without a cache: read-only too, made anew
        fresh = port_dataset.chunk_plans(pf.cells(1), pf.NUM_CELLS)
        for k in fresh:
            assert fresh[k] is not again[k] and not fresh[k].flags.writeable
            assert np.array_equal(fresh[k], again[k])


def _candidate(case):
    """(a batch array, whether `DevicePlans` may keep it on the device)."""
    plan = _read_only(np.arange(12, dtype=np.int32).reshape(3, 4) * 7)  # owns its memory
    if case == "broadcast":
        return np.broadcast_to(plan[None], (4, 3, 4)), True
    if case == "batch_slice":  # `DataGroup.local_rows`' block of rows
        return np.broadcast_to(plan[None], (4, 3, 4))[2:4], True
    if case == "writable_owner":
        return np.broadcast_to(np.arange(12, dtype=np.int32).reshape(3, 4)[None] + 0, (4, 3, 4)), False
    if case == "stacked":
        return np.stack([plan] * 4), False
    if case == "column_slice":  # not each row the owner
        return np.broadcast_to(plan[None], (4, 3, 4))[:, :, 1:], False
    if case == "view_of_owner":  # a read-only view of a writable array
        return np.broadcast_to(_read_only(np.arange(12, dtype=np.int32).reshape(3, 4)[None]), (4, 3, 4)), False
    if case == "transposed":
        square = _read_only(np.arange(9, dtype=np.int32).reshape(3, 3) + 0)
        return np.broadcast_to(square.T[None], (4, 3, 3)), False
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["broadcast", "batch_slice", "writable_owner", "stacked", "column_slice",
                                  "view_of_owner", "transposed"])
def test_only_a_stride0_view_of_a_read_only_owner_is_cached(case):
    a, cached = _candidate(case)
    plans = port_loop.DevicePlans(CPU)
    assert (plans.owner(a) is not None) is cached
    for call in range(2):
        t, copied, hit = plans.tensor(a)
        assert torch.equal(t, torch.from_numpy(np.array(a)))
        assert hit is (cached and call == 1)
        assert copied == (0 if hit else a.base.nbytes if cached else a.nbytes)
    assert (plans.hits, plans.misses, plans.entries) == ((1, 1, 1) if cached else (0, 0, 0))


def test_device_plans_keep_the_latest_owners():
    owners = [_read_only(np.full((2, 3), i, np.int32)) for i in range(3)]
    plans = port_loop.DevicePlans(CPU, capacity=2)
    for o in owners + [owners[0]]:  # the first was evicted by the third
        plans.tensor(np.broadcast_to(o[None], (4, 2, 3)))
    assert (plans.hits, plans.misses, plans.entries) == (0, 4, 2)
    plans.tensor(np.broadcast_to(owners[2][None], (2, 2, 3)))
    assert (plans.hits, plans.misses, plans.entries) == (1, 4, 2)


@pytest.mark.parametrize("case", ["shared", "mixed", "half_batch", "local_rows"])
def test_eval_step_bit_identical_to_copying_everything(pallas_model, case):
    step, cache = _step(pallas_model), {}
    batches = [port_dataset.collate_fn(pf.samples((5, 6, 5, 6) if case == "mixed" else (5,) * 4, cache, seed))
               for seed in (0, 1)]
    if case == "half_batch":  # the benchmark's fault: the first half of each batch
        batches = [{k: v[:2] if isinstance(v, np.ndarray) else v for k, v in b.items()} for b in batches]
    elif case == "local_rows":  # the second data index's rows of a node's batch
        group = types.SimpleNamespace(node_blocks=2, node_rank=1, n_view=1)
        batches = [DataGroup.local_rows(group, b) for b in batches]
    for batch in batches:
        assert pf.same(step(batch), pf.parent_step(pallas_model, batch, CPU))
    kept = 0 if case == "mixed" else len(pf.CHUNKS)  # the second batch finds the first's plans
    assert (step.plans.misses, step.plans.hits, step.plans.entries) == (kept, kept, kept)


def test_an_entry_goes_with_its_owner(pallas_model):
    step, cache = _step(pallas_model), {}
    batch = port_dataset.collate_fn(pf.samples((5,) * 4, cache))
    step(batch)
    assert step.plans.entries == len(pf.CHUNKS)
    del batch
    cache.clear()
    gc.collect()
    assert step.plans.entries == 0
    batch = port_dataset.collate_fn(pf.samples((5,) * 4, cache))  # the same values, new arrays
    with _profiled():
        step(batch)
    assert (step.plans.misses, step.plans.hits, step.plans.entries) == (6, 0, 3)
    assert _inputs_spans()[0]["plan_hits"] == 0.0


@pytest.mark.parametrize("mode,chunks,read", [
    ("pallas", True, pf.CHUNKS),
    ("pallas", False, ("camera_cells",)),
    ("matmul", True, ("camera_cells",)),
    ("scatter", True, ("camera_cells",)),
    ("culled", True, ("camera_cells",)),  # culled without pair plans
], ids=["pallas", "pallas_without_chunks", "matmul", "scatter", "culled_without_pairs"])
def test_only_the_plans_the_lift_reads_are_copied(mode, chunks, read):
    m = pf.model(mode)
    batch = port_dataset.collate_fn(pf.samples((5,) * 2, {}))
    if not chunks:
        batch = {k: v for k, v in batch.items() if k not in pf.CHUNKS}
    step = _step(m)
    assert m.reads(batch) == pf.INPUTS + tuple(read)  # in eval mode, as `_step` left it
    out, nbytes, hits = port_loop._on_device(m, batch, CPU, port_loop.DevicePlans(CPU))
    assert [k for k in port_dataset.ALL_PLAN_KEYS if k in out] == list(read)
    assert all(isinstance(out[k], torch.Tensor) for k in read)
    # the chunk plans are shared (one sample's rows copied), the cells not
    copied = sum(batch[k].nbytes // (2 if k in pf.CHUNKS else 1) for k in read)
    assert nbytes == sum(batch[k].nbytes for k in pf.INPUTS) + copied and hits == 0.0
    assert pf.same(step(batch), pf.parent_step(m, batch, CPU))


def test_h2d_bytes_and_plan_hits(pallas_model):
    step = _step(pallas_model)
    batch = port_dataset.collate_fn(pf.samples((5,) * 4, {}))
    with _profiled():
        step(batch)
        step(batch)
    inputs = sum(batch[k].nbytes for k in pf.INPUTS)
    one_sample = sum(batch[k].base.nbytes for k in pf.CHUNKS)
    assert one_sample * 4 == sum(batch[k].nbytes for k in pf.CHUNKS)
    assert _inputs_spans() == [{"h2d_bytes": inputs + one_sample, "plan_hits": 0.0},
                               {"h2d_bytes": inputs, "plan_hits": 1.0}]
