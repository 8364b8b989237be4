"""Host milliseconds a call inside the panel sweep (the program's ``sweep``
spans), less the time it waited in the sweep's read-backs (its
``panel.readback`` spans): Python and PyTorch's dispatch of the sweep."""

from portbench.attribution import host_ms
from portbench.program_spans import recorded


def read(rec):
    spans = recorded(rec)
    if not spans or not any(s.name == "sweep" for s in spans):
        return None
    return host_ms(spans, "sweep", less="panel.readback") / rec.calls
