"""The JAX package's dry run, run apart: ``python tests/_torch_jax_dryrun.py``
prints one line ``RESULT <json>`` for ``tests/test_torch_dryrun.py``.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) when it is
imported, which would reach every JAX process a test worker starts after
it; so it is imported here, in a process of its own.  The result holds:

* ``skipped``: ``lower_cell``'s record of every (arch, shape, mesh) that
  ``shape_applicable`` skips, for the full catalog;
* ``cells``: the SMOKE arch ``ARCH``'s train, prefill and decode cells at
  the small ``SHAPES`` below, on a 2×2 and a 1×1 host mesh (``Auto`` axes:
  jax 0.9's ``make_mesh`` defaults to explicit axes, which the package's
  sharding constraints do not take), and the SMOKE MoE archs' (``MOE``) on
  the 2×2 mesh under ``2x2/<arch>/<shape>``; each record with
  ``dot_flops``, the HLO parser's flops of the dots alone, and
  ``dense_dot_flops``, of the dots with a rank-2 output alone (the dense
  layers; the attention's products are batched).
"""
import json
import re

import jax

from repro.configs import ARCHS, SMOKES
from repro.launch import dryrun
from repro.models.config import SHAPES as FULL_SHAPES
from repro.models.config import ShapeConfig
from repro.roofline import analysis, hlo_parse

ARCH = "qwen2.5-3b"
SHAPES = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 128, 4, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode")}
MESHES = {"2x2": (2, 2), "1x1": (1, 1)}
MOE = ("deepseek-v2-236b", "llama4-scout-17b-a16e")

# the parser's elementwise kinds, renamed away so that it counts dots alone
_ELEMENTWISE = ("add", "multiply", "subtract", "divide", "maximum",
                "minimum", "compare", "select", "and", "or", "xor",
                "negate", "abs", "floor", "ceil", "round-nearest-afz",
                "clamp") + tuple(sorted(hlo_parse._TRANS_KINDS))
_KINDS = re.compile(r"(\s)(" + "|".join(re.escape(k) for k in _ELEMENTWISE)
                    + r")\(")
_BATCHED_DOT = re.compile(
    r"(=\s*\w+\[[\d,]*,[\d,]*,[\d,]*\]\{[\d,]*\}\s*)dot\(")


def main():
    out = {"skipped": [], "cells": {}}
    for arch in ARCHS:
        for shape in FULL_SHAPES:
            if dryrun.shape_applicable(ARCHS[arch], FULL_SHAPES[shape])[0]:
                continue
            for multi in (False, True):
                out["skipped"].append(
                    dryrun.lower_cell(arch, shape, multi, verbose=False))

    dots = {}
    parse = analysis.analyze_compiled

    def capture(compiled, chips, model_flops=0.0, hlo_text=None):
        text = compiled.as_text()
        only_dots = _KINDS.sub(r"\1x\2(", text)
        dots["dot"] = hlo_parse.analyze(only_dots).flops
        dots["dense"] = hlo_parse.analyze(
            _BATCHED_DOT.sub(r"\1xdot(", only_dots)).flops
        return parse(compiled, chips=chips, model_flops=model_flops,
                     hlo_text=text)

    dryrun.roofline.analyze_compiled = capture
    dryrun.ARCHS = dict(SMOKES)
    dryrun.SHAPES = SHAPES
    for mesh_name, shape in MESHES.items():
        n = shape[0] * shape[1]
        dryrun.make_production_mesh = (
            lambda multi_pod=False, shape=shape, n=n: jax.make_mesh(
                shape, ("data", "model"), devices=jax.devices()[:n],
                axis_types=(jax.sharding.AxisType.Auto,) * 2))
        cells = [(ARCH, name, f"{mesh_name}/{name}") for name in SHAPES]
        if mesh_name == "2x2":
            cells += [(arch, name, f"{mesh_name}/{arch}/{name}")
                      for arch in MOE for name in SHAPES]
        for arch, name, key in cells:
            rec = dryrun.lower_cell(arch, name, False, verbose=False)
            rec["dot_flops"] = dots.pop("dot")
            rec["dense_dot_flops"] = dots.pop("dense")
            out["cells"][key] = rec
    print("RESULT " + json.dumps(out))


if __name__ == "__main__":
    main()
