"""Phase timing accumulation.

Same taxonomy as the reference (whisper_state t_mel/t_encode/t_decode/
t_batchd/t_prompt + counts, src/whisper.cpp:868-881; report at 4261-4312):
mel / encode / prompt (multi-token decode) / decode (single-token) / sample.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict


@dataclasses.dataclass
class PhaseStat:
    total_s: float = 0.0
    calls: int = 0


class Timings:
    def __init__(self):
        self.phases: Dict[str, PhaseStat] = collections.defaultdict(PhaseStat)

    def add(self, phase: str, seconds: float, n: int = 1) -> None:
        st = self.phases[phase]
        st.total_s += seconds
        st.calls += n

    def get(self, phase: str) -> PhaseStat:
        return self.phases[phase]

    def reset(self) -> None:
        """reference whisper_reset_timings (src/whisper.cpp:4298)."""
        self.phases.clear()

    def report(self) -> str:
        """reference whisper_print_timings format (src/whisper.cpp:4270-4296)."""
        lines = []
        for name, st in sorted(self.phases.items()):
            per = st.total_s * 1000.0 / max(1, st.calls)
            lines.append(
                f"{name:>10} time = {st.total_s * 1000.0:8.2f} ms / "
                f"{st.calls:5d} runs ({per:8.2f} ms per run)")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_ms": v.total_s * 1e3, "calls": v.calls}
                for k, v in self.phases.items()}
