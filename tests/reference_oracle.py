"""Run the REFERENCE's own data loaders as a golden oracle.

Validation against the reference's own pipeline.  Real dataset files are unobtainable here (no
network), so validation runs the reference's loader code — which is pure
numpy/scipy/networkx, no TF compute (gcn/utils.py:33-335) — on replica
fixture files (stochastic_gcn_tpu/data/fixtures.py) and compares its
output tensors bit-for-bit against ours.

The reference source is read from /root/reference AT TEST TIME and exec'd
with mechanical py2→py3 / modern-library compatibility patches; nothing is
copied into this repo.  Patches (each is a literal substitution, asserted
to hit, so drift in the reference text fails loudly):

* ``import tensorflow as tf``           → fake module exposing app.flags
* ``scipy.sparse.linalg.eigen.arpack``  → stub (module gone in scipy>=1.8;
                                          eigsh is never called by loaders)
* py2 dict methods (iteritems/has_key/keys()[0]/values()[0]), list(map)
* ``G.node[...]``                       → ``G.nodes[...]`` (networkx>=2)
* node_link_graph(...)                  → ``edges="links"`` (networkx>=3.6
                                          renamed the kwarg)
* the networkx<=1.11 version assert     → removed

The oracle is skipped when /root/reference is absent (e.g. external CI).
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np

REFERENCE_UTILS = "/root/reference/gcn/utils.py"

_PY3_PATCHES = [
    # (old, new, required)
    ("import tensorflow as tf", "import _ref_oracle_tf as tf", True),
    ("from scipy.sparse.linalg.eigen.arpack import eigsh",
     "eigsh = None  # unused by loaders", True),
    ("version_info = map(int, nx.__version__.split('.'))",
     "version_info = [99, 0]  # compat harness", True),
    ('assert (major <= 1) and (minor <= 11), "networkx major version must '
     'be <= 1.11 in order to load graphsage data"', "", True),
    ("G = json_graph.node_link_graph(G_data)",
     'G = json_graph.node_link_graph(G_data, edges="links")', True),
    ("id_map.keys()[0]", "list(id_map.keys())[0]", True),
    ("id_map.iteritems()", "id_map.items()", True),
    ("class_map.iteritems()", "class_map.items()", True),
    ("class_map.values()[0]", "list(class_map.values())[0]", False),
    ("isinstance(class_map.values()[0], list)",
     "isinstance(list(class_map.values())[0], list)", False),
    ("id_map.has_key(", "id_map.__contains__(", True),
    ("G.node[", "G.nodes[", True),
]


class _Flags:
    """Stand-in for tf.app.flags.FLAGS with just the attrs utils.py reads."""

    def __init__(self, normalization="gcn", max_degree=-1):
        self.normalization = normalization
        self.max_degree = max_degree


def _fake_tf(flags: _Flags) -> types.ModuleType:
    tf = types.ModuleType("_ref_oracle_tf")
    app = types.ModuleType("_ref_oracle_tf.app")
    fl = types.ModuleType("_ref_oracle_tf.app.flags")
    fl.FLAGS = flags
    app.flags = fl
    tf.app = app
    return tf


def load_reference_utils(normalization: str = "gcn", max_degree: int = -1):
    """Exec the patched reference utils.py; returns its module namespace.

    The returned module's loaders use relative paths ('data/ind...') — the
    caller must chdir into the fixture directory first.
    """
    if not os.path.exists(REFERENCE_UTILS):
        return None
    with open(REFERENCE_UTILS) as f:
        src = f.read()
    for old, new, required in _PY3_PATCHES:
        if old not in src:
            if required:
                raise AssertionError(
                    f"reference utils.py drifted: patch source not found: "
                    f"{old!r}")
            continue
        src = src.replace(old, new)

    flags = _Flags(normalization=normalization, max_degree=max_degree)
    mod = types.ModuleType("_reference_utils_oracle")
    sys.modules["_ref_oracle_tf"] = _fake_tf(flags)
    try:
        if not hasattr(np, "bool"):       # numpy<2.0 removed the alias
            np.bool = np.bool_            # pragma: no cover
        code = compile(src, REFERENCE_UTILS, "exec")
        exec(code, mod.__dict__)
    finally:
        sys.modules.pop("_ref_oracle_tf", None)
    mod.FLAGS = flags
    return mod


def as_dense(m) -> np.ndarray:
    """scipy sparse (matrix or array) or ndarray → dense float64 ndarray."""
    if hasattr(m, "toarray"):
        return np.asarray(m.toarray(), dtype=np.float64)
    return np.asarray(m, dtype=np.float64)
