"""Every TPU kernel of the repository has a Hopper counterpart on record.

The TPU kernels are the ``pl.pallas_call(...)`` calls in ``se3conv3d_tpu/``
and ``experiments/``, found with ``ast`` (a mention in a docstring or a
comment is no call).  ``PERF.md``'s table "TPU kernels and their ports"
names each call's ``path:line`` in full in a row whose Port column names a
CUDA source (``*.cu``) of the port, and that source exists.
"""
import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "se3conv3d_tpu_torch", "kernels", "csrc")
N_SITES = 21


def pallas_call_sites() -> list:
    sites = []
    for top in ("se3conv3d_tpu", "experiments"):
        for root, _, files in os.walk(os.path.join(REPO, top)):
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(root, name)
                with open(path) as f:
                    tree = ast.parse(f.read(), path)
                for node in ast.walk(tree):
                    fn = getattr(node, "func", None)
                    if isinstance(node, ast.Call) and (isinstance(fn, ast.Attribute) and fn.attr == "pallas_call"
                                                       or isinstance(fn, ast.Name) and fn.id == "pallas_call"):
                        sites.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    return sorted(sites)


def kernel_table_rows() -> list:
    """``(site cell, port cell)`` of each row of PERF.md's kernel table."""
    with open(os.path.join(REPO, "PERF.md")) as f:
        text = f.read()
    start = text.index("| TPU kernel")
    rows = []
    for line in text[start:].splitlines()[2:]:
        if not line.startswith("|"):
            break
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        rows.append((cells[0], cells[1]))
    return rows


def test_every_pallas_call_is_found():
    sites = pallas_call_sites()
    assert len(sites) == N_SITES, sites
    # a docstring that names pallas_call is not a site
    assert not any(s.startswith("experiments/chip_oom_repro.py") for s in sites)


def test_every_site_has_a_cuda_counterpart_in_perf_md():
    rows = kernel_table_rows()
    assert rows, "no kernel table in PERF.md"
    for site in pallas_call_sites():
        pattern = re.compile(re.escape(site) + r"(?!\d)")
        ports = [port for cell, port in rows if pattern.search(cell)]
        assert ports, f"{site} is not named in full in PERF.md's kernel table"
        sources = [src for port in ports for src in re.findall(r"([\w]+\.cu)\b", port)]
        assert sources, f"{site}: its row names no CUDA source"
        assert all(os.path.exists(os.path.join(CSRC, src)) for src in sources), sources
    assert not any("still to be ported" in port for _, port in rows)
