"""The SHA-256 of each registered solution's emitted CUDA source
(``cuda_emit.emit``) at element sizes 2, 4 and 8, or the reason the
emitter refuses it.

    python -m yask_tpu_torch.ops.emit_digest OUT.json [SOLUTION ...]

writes ``{"<solution> <bytes>": "<sha256>" or "refused: <reason>"}`` for
the named solutions (all registered ones by default); "refused" also
records an emitter that fails otherwise than by refusing.  Two checkouts'
files compare an emitter change source by source: which sources it
changed, which it left byte-identical, which it newly admits.  The
module uses only ``create_solution``, ``get_registered_solutions`` and
``cuda_emit.emit``, so a copy of it runs in an older checkout too.
"""

from __future__ import annotations

import hashlib
import json
import sys
from typing import Dict, Iterable, Optional

ELEMENT_BYTES = (2, 4, 8)


def digests(names: Optional[Iterable[str]] = None,
            element_bytes=ELEMENT_BYTES) -> Dict[str, str]:
    """``{"<solution> <bytes>": digest or "refused: ..."}``, prepared on
    the CPU at a small domain (the source does not depend on its size)."""
    import yask_tpu_torch
    from yask_tpu_torch.compiler.solution_base import (
        create_solution, get_registered_solutions)
    from yask_tpu_torch.ops import cuda_emit
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env(device="cpu")
    out = {}
    for name in sorted(names or get_registered_solutions()):
        for eb in element_bytes:
            src = create_solution(name)
            src.get_soln().set_element_bytes(eb)
            ctx = fac.new_solution(env, src)
            g = 12 if len(ctx._ana.domain_dims) < 4 else 6
            ctx.apply_command_line_options(f"-g {g} -mode torch")
            ctx.prepare_solution()
            try:
                source = cuda_emit.emit(ctx._program).source
            except Exception as e:  # a refusal, or a fault to record
                out[f"{name} {eb}"] = f"refused: {type(e).__name__}: {e}"
                continue
            out[f"{name} {eb}"] = hashlib.sha256(source.encode()).hexdigest()
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    with open(argv[0], "w") as f:
        json.dump(digests(argv[1:] or None), f, indent=0, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
