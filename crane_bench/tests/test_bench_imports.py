"""A CPU dry run of the harness loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``crane_tpu``, compared whole (the port,
``crane_tpu_torch``, is not ``crane_tpu``), and the reference files import
nothing of the port."""

import ast
import json
import subprocess
import sys

from crane_bench.run import FORBIDDEN, forbidden_modules
from crane_bench.spec import HERE
from crane_bench.tests.tiny import ROOT

DRY_RUN = """
import json, sys
from crane_bench import run
from crane_bench.tests.tiny import tiny_cell
run.run_cell(tiny_cell("qwen3-next-80b-a3b.decode-heavy", clients=2), 3, 2.0, False, "cpu")
run.run_cell(tiny_cell("qwen3-0.6b.chat", clients=2), 3, 2.0, False, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_dry_run_loads_no_jax_and_no_crane_tpu():
    out = subprocess.run([sys.executable, "-c", DRY_RUN], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "crane_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "crane_tpu_torch_fake.sub", object())
    assert forbidden_modules() == [m for m in forbidden_modules() if m.split(".")[0] in FORBIDDEN]
    assert "crane_tpu_torch_fake.sub" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "crane_tpu.fake", object())
    assert "crane_tpu.fake" in forbidden_modules()


def test_references_import_nothing_of_the_program():
    for path in sorted((HERE / "models").glob("*.py")) + [HERE / "check.py", HERE / "weights.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("crane_tpu_torch", *FORBIDDEN), (path, name)
