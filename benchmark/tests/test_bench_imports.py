"""Nothing the harness or the reference imports is JAX or the JAX package,
and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.cell import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "mhap_tpu"}


def imported_top_names(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def sources(sub=""):
    for d, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in os.path.relpath(d, BENCH).split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_in_the_harness():
    for p in sources():
        assert not imported_top_names(p) & JAX, p


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        assert not imported_top_names(p) & (JAX | {"mhap_tpu_torch"}), p


def test_loaded_modules_by_whole_top_name():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.overlaps, benchmark.reference.filter\n"
        "tops = {m.split('.', 1)[0] for m in sys.modules}\n"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'mhap_tpu',"
        " 'mhap_tpu_torch'}, tops\n"
        "import benchmark.cell, mhap_tpu_torch.cli.main\n"
        "from benchmark.cell import banned_modules\n"
        "assert banned_modules() == [], banned_modules()\n"
        "import types; sys.modules['mhap_tpu'] = types.ModuleType('x')\n"
        "assert banned_modules() == ['mhap_tpu']\n" % ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
