"""The eval step's device plan cache on a card: the batch whose chunk plans
the cache already holds gives the detections of the batch that copied them
(and of the step that copies every array), bit for bit, and its trace holds
no host-to-device copy of a plan.

This file imports neither jax, flax nor the JAX package, so that on a machine
with a card

    python -m pytest tests/test_torch_plan_feed_cuda.py -m cuda

runs it; it skips without a card.
"""

import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plan_feed_helpers as pf
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _traced_step(step, batch, path):
    """The step's detections, and the bytes of each host-to-device copy in
    its trace."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = step(batch)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    copies = [e["args"]["bytes"] for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return out, copies


@pytest.mark.cuda
def test_a_hit_gives_the_same_detections_and_copies_no_plan(cuda_device, tmp_path):
    model = pf.model()
    step = port_loop.make_eval_step(model, port_config.CompatFlags(), device=cuda_device)
    step(port_dataset.collate_fn(pf.samples((6,) * 4, {})))  # warm-up on another calibration
    batch = port_dataset.collate_fn(pf.samples((5,) * 4, {}))
    miss, miss_copies = _traced_step(step, batch, tmp_path / "miss.json")
    hit, hit_copies = _traced_step(step, batch, tmp_path / "hit.json")
    assert (step.plans.misses, step.plans.hits) == (2 * len(pf.CHUNKS), len(pf.CHUNKS))
    assert pf.same(hit, miss) and pf.same(hit, pf.parent_step(model, batch, cuda_device))
    # the two steps' copies differ by one sample's rows of each plan, which
    # only the miss copies; the inputs are copied by both
    assert Counter(miss_copies) - Counter(hit_copies) == Counter(batch[k].base.nbytes for k in pf.CHUNKS)
    assert not Counter(hit_copies) - Counter(miss_copies)
    assert all(Counter(hit_copies)[batch[k].nbytes] for k in pf.INPUTS)
