"""Import hygiene, each in a fresh interpreter: the harness, every metric
reader, the loops and the reference load no JAX and nothing of the JAX
package (top-level names compared whole), and the reference loads
nothing of the port."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import json, sys
from pathlib import Path
sys.path[:0] = [{src!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

HARNESS = """
from portbench import harness, spec, counts, trace, faults, sut, ranks
for p in sorted((Path({root!r}) / "portbench" / "metrics").glob("*.py")):
    spec.load_module(p)
for p in sorted((Path({root!r}) / "portbench" / "loops").glob("*.py")):
    spec.load_module(p)
import portbench.reference.train, portbench.reference.dense
import portbench.reference.hybrid
"""

REFERENCE = """
import portbench.reference.common, portbench.reference.dense
import portbench.reference.hybrid, portbench.reference.train
"""


def loaded(body: str) -> set:
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        body=body.format(root=str(ROOT)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded(HARNESS)
    assert "repro_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    names = loaded(REFERENCE)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", "minicpm-2b.score_b24_l2048", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
