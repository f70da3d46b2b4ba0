"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PORT = "bevfusion_multimodal_3d_object_detection_tpu_torch"

BLOCK = f"""
import sys, importlib.abc
FORBIDDEN = {{"jax", "jaxlib", "flax", "optax", "orbax", "bevfusion_multimodal_3d_object_detection_tpu"}}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", BLOCK + code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_the_harness_and_what_it_runs_load_no_jax():
    _run(f"""
import importlib.util, runpy
from core import registry, harness
spec = importlib.util.spec_from_file_location("run", {str(BENCH / 'run.py')!r}); spec.loader.exec_module(importlib.util.module_from_spec(spec))
bench = registry.benchmark()
for w in bench["workloads"]:
    registry.driver(registry.workload(w["name"])["driver"])
for m in bench["per_layer"]:
    registry.reader(m["name"])
import reference.model, reference.train, reference.decode, reference.geometry
# what the drivers import of the program
import {PORT}.serving, {PORT}.train.loop, {PORT}.data.dataset, {PORT}.utils.convert, {PORT}.utils.cache
import {PORT}.ops.bev_splat, {PORT}.ops.decode, {PORT}.ops.pointnet_fused
assert not harness.forbidden_modules(), harness.forbidden_modules()
""")


def test_forbidden_names_are_compared_whole():
    from core.harness import forbidden_modules

    assert forbidden_modules([PORT, PORT + ".serving", "jaxtyping"]) == []
    assert forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]
    assert forbidden_modules(["bevfusion_multimodal_3d_object_detection_tpu.models"]) == [
        "bevfusion_multimodal_3d_object_detection_tpu"]


def test_the_reference_loads_nothing_of_the_program():
    out = _run("""
import sys
import reference.model, reference.train, reference.decode, reference.geometry
print(sorted({m.split(".", 1)[0] for m in sys.modules}))
""")
    assert PORT not in out and "core" not in out.split("'")
