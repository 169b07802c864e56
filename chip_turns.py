#!/usr/bin/env python3
"""This checkout and another tree of the repo, timed in turns on one card
by this checkout's yardsticks.

    python3 chip_turns.py OTHER_SRC

OTHER_SRC is the ``src`` directory of another tree, e.g. a ``git archive``
of the parent commit unpacked into ``_parent/`` (``_parent/src``). Four
processes run one after another, other, this, this, other. Each imports its
tree's ``repro_torch``, then ``chip_smoke.py`` from this checkout, and runs
on its tree:

- ``pack_quant_rows`` (int8 from float32) at the training path's two
  shapes, one layer row of a stacked moment and 4096 scattered
  embedding-moment rows, as ``chip_smoke.py``'s ``phase_quant_times`` does:
  the result checked byte for byte against the plain version, the starts
  rotating between calls, the call by ``median_ms`` (CUDA events, median of
  20) and its kernels alone on the device by ``device_ms`` (per call, from
  the wrapper's launch count); one JSON line;
- ``chip_smoke.py``'s ``phase_ssd_times`` (the SSD kernel at the serving
  shape) and ``phase_serve_ssm`` (mamba2-2.7b served at full width, its
  prefill profiled by kernel class), which print their own lines.

Needs one CUDA card.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def one(src: Path) -> dict:
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401  the tree's package, before chip_smoke puts this checkout's first

    import chip_smoke as cs
    import numpy as np
    import torch

    rq = cs.rq
    assert Path(rq.__file__).resolve().is_relative_to(src), rq.__file__
    assert torch.cuda.is_available(), "no CUDA device"
    # the tree's pack kernels: one a call on a route, or (before the routes)
    # tile_absmax_kernel then tile_quant_kernel
    kernel = "pack_quant_" if hasattr(rq, "route") else "tile_"
    cases = {
        "stacked_row": (cs.STACKED_MOMENT, [[i] for i in range(cs.STACKED_MOMENT[0])]),
        "embed_4096": (cs.EMBED, [[int(x) for x in np.random.default_rng(s).permutation(cs.EMBED[0])[:4096]]
                                  for s in range(8)]),
    }
    out = {"src": str(src), "card": cs.phase_card()}
    for case, (shape, start_sets) in cases.items():
        x = cs.rand_rows(shape, torch.float32, 31) * 1e-3
        q, s = rq.pack_quant_rows_cuda(x, start_sets[0], 1, "int8")
        q_r, s_r = cs.R.pack_quant_rows_ref(x, start_sets[0], 1, "int8")
        assert torch.equal(cs._bytes(q), cs._bytes(q_r)) and torch.equal(cs._bytes(s), cs._bytes(s_r)), case
        turn = itertools.cycle(start_sets)

        def call():
            return rq.pack_quant_rows_cuda(x, next(turn), 1, "int8")

        out[case] = {"ms": cs.median_ms(call, reps=20),
                     "device_ms": cs.device_ms(call, kernel, per_call=lambda: rq.launches["pack_quant_rows"])}
        del x, q, s, q_r, s_r
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    launches, err = cs.phase_serve_ssm()
    cs.phase_ssd_times(launches, err)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(Path(sys.argv[2]).resolve())
        return 0
    other, this = Path(sys.argv[1]).resolve(), HERE / "src"
    for src in (other, this, this, other):
        subprocess.run([sys.executable, __file__, "--one", str(src)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
