"""Abaqus ``.inp`` mesh reader (NumPy copy of the JAX package's
``io/inp.py``).

Reference parity: ``InpParser`` (parse_inp.py:8-229) — supports *NODE,
*ELEMENT (CPS3 / C3D8R / C3D10; unsupported types are skipped) and *NSET
sections; 1-based indices converted to 0-based; nodes/elements sorted by
their file indices with gap-free validation; returns
``(conn: dict, X, groups: dict)`` plus a ``to_vtk`` convenience.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .vtk import to_vtk

__all__ = ["InpParser", "parse_inp"]

SUPPORTED_ELEMENTS = {
    "CPS3": 3,  # three-node plane stress
    "C3D8R": 8,  # linear brick
    "C3D10": 10,  # ten-node tet
}

_HEADER = re.compile(r"\*(\w+)")
_KWARG = re.compile(r"(\w+)=(\w+)")


class InpParser:
    """Parse an Abaqus .inp file into numpy mesh arrays."""

    def __init__(self, inp_name):
        self.inp_name = inp_name
        self.conn = None
        self.X = None
        self.groups = None

    def parse(self):
        """Returns (conn: {etype: array}, X: (nnodes, 3),
        groups: {name: nodes})."""
        chunks = self._load_chunks()
        X_rows = []
        conn = {}
        groups = {}
        for chunk in chunks:
            kind = chunk["kind"].lower()
            if kind == "node":
                X_rows.extend(self._parse_indexed(chunk["lines"], float, 0))
            elif kind == "element":
                etype = chunk.get("type")
                if etype not in SUPPORTED_ELEMENTS:
                    continue
                rows = self._parse_indexed(chunk["lines"], int, -1)
                arr = np.array(rows, dtype=np.int64)
                # several sections of one type (per-ELSET chunks)
                # concatenate; the reference kept only the last
                # (parse_inp.py:73-75)
                if etype in conn:
                    arr = np.concatenate([conn[etype], arr])
                conn[etype] = arr
            elif kind == "nset":
                nodes = []
                for line in chunk["lines"]:
                    nodes.extend(
                        int(v) - 1 for v in line.strip(", \n").split(",")
                        if v.strip()
                    )
                groups[chunk.get("nset", f"nset{len(groups)}")] = np.array(
                    nodes, dtype=np.int64
                )
        self.X = np.array(X_rows, dtype=float)
        self.conn = conn
        self.groups = groups
        return conn, self.X, groups

    def to_vtk(self, nodal_sol=None, vtk_name=None):
        if self.conn is None:
            self.parse()
        if vtk_name is None:
            vtk_name = os.path.splitext(self.inp_name)[0] + ".vtk"
        to_vtk(self.conn, self.X, nodal_sol or {}, vtk_name)

    # -- internals -----------------------------------------------------------

    def _load_chunks(self):
        chunks = []
        with open(self.inp_name) as fh:
            for line in fh:
                line = line.strip()
                if line.startswith("**"):
                    continue
                m = _HEADER.search(line)
                if m:
                    chunk = {"kind": m.group(1), "lines": []}
                    for key, value in _KWARG.findall(line):
                        chunk[key.lower()] = value
                    chunks.append(chunk)
                elif chunks and line:
                    chunks[-1]["lines"].append(line)
        return chunks

    @staticmethod
    def _parse_indexed(lines, dtype, offset):
        """Parse '<idx>, v1, v2, ...' lines; sort by idx; validate gap-free."""
        idx = []
        rows = []
        for line in lines:
            vals = [v for v in line.strip(", \n").split(",") if v.strip()]
            idx.append(int(float(vals[0])))
            rows.append([dtype(float(v)) + offset for v in vals[1:]])
        idx = np.asarray(idx)
        # AssertionError, as the JAX parser raises, but kept under -O
        if len(idx) and not (len(set(idx.tolist())) == len(rows)
                             == idx.max() - idx.min() + 1):
            raise AssertionError("indices must be unique and gap-free")
        order = np.argsort(idx, kind="stable")
        return [rows[i] for i in order]


def parse_inp(inp_name):
    """Functional convenience wrapper."""
    return InpParser(inp_name).parse()


if __name__ == "__main__":  # CLI parity with parse_inp.py:232-238
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("inp", type=str, metavar="[inp file]")
    args = ap.parse_args()
    parser = InpParser(args.inp)
    parser.parse()
    parser.to_vtk()
