"""No module a run loads is JAX's or the JAX package's, compared by whole
top-level names (``distkeras_tpu_torch`` begins with ``distkeras_tpu`` and
is allowed), and the reference loads nothing of the program. Each check runs
in a fresh interpreter, whose ``sys.modules`` holds only what it loaded."""

from __future__ import annotations

import json
import subprocess
import sys

from perfbench.manifest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "distkeras_tpu"}


def _top_level_modules(code: str) -> set[str]:
    script = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in " \
                    "sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level_modules(
        "import perfbench.run, perfbench.calibrate, perfbench.ranks\n"
        "from perfbench import manifest, harness\n"
        "from perfbench.tests.tiny import tiny_spec\n"
        "spec = tiny_spec()\n"
        "[manifest.reader(m['name']) for m in manifest.load()['per_layer']]\n"
        "harness.run_rank(spec, 3, 0.2, True, device='cpu')\n")
    assert "distkeras_tpu_torch" in loaded  # the port did load
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_harness_names_what_it_finds():
    from perfbench.harness import forbidden_modules

    found = forbidden_modules()
    assert set(found) <= FORBIDDEN
    assert "distkeras_tpu_torch" not in found


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules("import perfbench.reference.bert_family")
    assert not loaded & (FORBIDDEN | {"distkeras_tpu_torch"})
