"""Nothing the benchmark runs on the chip loads JAX or the JAX package,
and the reference loads nothing of the port. Module names are compared
by their top-level name whole: the port's name begins with the JAX
package's."""
import ast
import json
import subprocess
import sys

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "wsi_hgnn_tpu"}

LOAD_ALL = f"""
import json, sys, importlib.util, pathlib
bench = pathlib.Path({str(BENCH)!r})
sys.path[:0] = [str(bench), str(bench.parent), str(bench / "loadgen")]
import run, calibrate, sweep, common, models, roofline
import open_loop, bodies
for kind in ("traffic", "metrics"):
    for path in sorted((bench / kind).glob("*.py")):
        spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
# what the drivers import of the port when they run
import wsi_hgnn_tpu_torch.serve, wsi_hgnn_tpu_torch.train.trainer, wsi_hgnn_tpu_torch.convert
import wsi_hgnn_tpu_torch.kernels, wsi_hgnn_tpu_torch.models.featurizers
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = f"""
import json, sys, pathlib
sys.path[:0] = [{str(BENCH)!r}]
import reference.cnn, reference.gnn, reference.train, reference.weights, reference.precision
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    names = top_level_names(LOAD_ALL)
    assert "wsi_hgnn_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_port_or_jax():
    names = top_level_names(LOAD_REFERENCE)
    assert not names & (FORBIDDEN | {"wsi_hgnn_tpu_torch"})


def test_no_source_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, f"{path}: {tops}"
            if "reference" in path.parts:
                assert "wsi_hgnn_tpu_torch" not in tops, path
