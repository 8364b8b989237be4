"""Host milliseconds a call spent in the panel sweep's read-backs (the
program's ``panel.readback`` spans): the host waiting for the device's
ranks and miss flags."""

from portbench.attribution import host_ms
from portbench.program_spans import recorded


def read(rec):
    spans = recorded(rec)
    if not spans or not any(s.name == "sweep" for s in spans):
        return None
    return host_ms(spans, "panel.readback") / rec.calls
