"""rom.inputs_host_ms_per_batch: host milliseconds inside the program's
rom.traj_inputs spans (the per-mu source terms, their stack and the
initial state's expand) over the batches (rom.traj_batch spans), in a
pass with spans on and no profiler."""

from gpubench import spans as sp


def read(run):
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    ms = sp.span_ms(spans, "rom.traj_inputs")
    batches = sum(1 for s in spans if s.name == "rom.traj_batch")
    if ms is None or not batches:
        return None
    return ms / batches
