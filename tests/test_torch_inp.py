"""PyTorch port, the Abaqus ``.inp`` reader and the mesh synthesizers.

``pyfem_gpu_testflight_tpu_torch.io.inp.InpParser`` against the JAX
package's ``InpParser`` on the synthesized torque arm (CPS3) and C3D10
bracket: identical ``conn``, ``X`` and node sets; the parser cases of
``tests/test_io.py`` (unsupported element types skipped, 1-based to
0-based, sorting by index, the gap check's AssertionError, the VTK
convenience); and the port's ``examples`` synthesizers writing the JAX
examples' bytes.
"""

import filecmp
import importlib.util
import os
import sys

import numpy as np
import pytest

import pyfem_gpu_testflight_tpu as fem

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch.examples import bracket3d_topo, torque_arm

import torch_threads  # noqa: F401  (one torch thread per worker)

_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _jax_example(name):
    """A JAX example module, loaded from its file (the examples import
    each other by bare name, so their folder goes on sys.path)."""
    if _EXAMPLES not in sys.path:
        sys.path.insert(0, _EXAMPLES)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(_EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


INP_SAMPLE = """*Heading
** a tiny mixed file with comments
*NODE
1, 0.0, 0.0, 0.0
2, 1.0, 0.0, 0.0
3, 1.0, 1.0, 0.0
4, 0.0, 1.0, 0.0
*ELEMENT, type=T3D2
1, 1, 2
*ELEMENT, type=CPS3
1, 1, 2, 3
2, 3, 4, 1
*NSET, nset=fixed
1, 4
*NSET, nset=load
2, 3
"""


def _same_parse(path):
    conn, X, groups = pt.InpParser(str(path)).parse()
    conn_j, X_j, groups_j = fem.InpParser(str(path)).parse()
    assert list(conn) == list(conn_j)
    for k in conn:
        assert conn[k].dtype == conn_j[k].dtype
        np.testing.assert_array_equal(conn[k], conn_j[k])
    assert X.dtype == X_j.dtype
    np.testing.assert_array_equal(X, X_j)
    assert list(groups) == list(groups_j)
    for k in groups:
        np.testing.assert_array_equal(groups[k], groups_j[k])
    return conn, X, groups


@pytest.mark.parametrize("mesh", ["arm", "bracket"])
def test_parser_matches_jax_on_synthesized_meshes(tmp_path, mesh):
    path = tmp_path / f"{mesh}.inp"
    if mesh == "arm":
        torque_arm.synthesize_arm_inp(str(path), nr=12, nt=80)
        conn, X, groups = _same_parse(path)
        assert conn["CPS3"].shape == (2 * 11 * 79, 3) and X.shape == (960, 3)
    else:
        bracket3d_topo.synthesize_bracket_inp(str(path), n=5)
        conn, X, groups = _same_parse(path)
        assert conn["C3D10"].shape[1] == 10 and X.shape == (9 * 5 * 5, 3)
    assert set(groups) == {"fixed", "load"}


def test_parser_roundtrip_and_vtk(tmp_path):
    path = tmp_path / "tiny.inp"
    path.write_text(INP_SAMPLE)
    parser = pt.InpParser(str(path))
    conn, X, groups = _same_parse(path)
    # unsupported T3D2 filtered out
    assert list(conn) == ["CPS3"]
    np.testing.assert_array_equal(conn["CPS3"], [[0, 1, 2], [2, 3, 0]])
    np.testing.assert_allclose(X[2], [1.0, 1.0, 0.0])
    np.testing.assert_array_equal(groups["fixed"], [0, 3])
    np.testing.assert_array_equal(groups["load"], [1, 2])
    parser.to_vtk({"z": np.zeros(4)})
    assert (tmp_path / "tiny.vtk").exists()
    assert (tmp_path / "tiny.vtk").read_text().startswith("# vtk DataFile")


def test_parser_unsorted_and_gap_checked(tmp_path):
    path = tmp_path / "shuffled.inp"
    path.write_text(
        "*NODE\n2, 1.0, 0.0, 0.0\n1, 0.0, 0.0, 0.0\n3, 0.0, 1.0, 0.0\n"
        "*ELEMENT, type=CPS3\n1, 1, 2, 3\n"
    )
    conn, X, groups = _same_parse(path)
    np.testing.assert_allclose(X[:, 0], [0.0, 1.0, 0.0])  # sorted by index

    bad = tmp_path / "gap.inp"
    bad.write_text("*NODE\n1, 0, 0, 0\n3, 1, 0, 0\n")
    for parser in (pt.InpParser, fem.InpParser):
        with pytest.raises(AssertionError):
            parser(str(bad)).parse()


def test_parser_concatenates_sections_of_one_type(tmp_path):
    path = tmp_path / "sections.inp"
    path.write_text(
        "*NODE\n1, 0, 0, 0\n2, 1, 0, 0\n3, 1, 1, 0\n4, 0, 1, 0\n"
        "*ELEMENT, type=CPS3, elset=a\n1, 1, 2, 3\n"
        "*ELEMENT, type=CPS3, elset=b\n2, 3, 4, 1\n"
        "*NSET, nset=all\n1, 2,\n3, 4\n"
    )
    conn, _X, groups = _same_parse(path)
    np.testing.assert_array_equal(conn["CPS3"], [[0, 1, 2], [2, 3, 0]])
    np.testing.assert_array_equal(groups["all"], [0, 1, 2, 3])


@pytest.mark.parametrize("case", ["arm_default", "arm_12x80", "bracket_5",
                                  "bracket_5_nx9"])
def test_synthesizers_write_the_jax_examples_bytes(tmp_path, case):
    if case.startswith("arm"):
        jax_fn = _jax_example("torque_arm").synthesize_arm_inp
        port_fn = torque_arm.synthesize_arm_inp
        kw = {} if case == "arm_default" else dict(nr=12, nt=80)
    else:
        jax_fn = _jax_example("bracket3d_topo").synthesize_bracket_inp
        port_fn = bracket3d_topo.synthesize_bracket_inp
        kw = dict(n=5) if case == "bracket_5" else dict(n=5, nx=9)
    a, b = tmp_path / "jax.inp", tmp_path / "port.inp"
    assert port_fn(str(b), **kw) == str(b)
    jax_fn(str(a), **kw)
    assert filecmp.cmp(a, b, shallow=False)
