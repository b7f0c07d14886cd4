"""Host milliseconds a call in the program's own Python and launches: the
host time of each ``amr.demod_pack_batch`` span less its ``amr.host_read``
spans (the host's waits for the card)."""

from portbench import spans


def read(ctx):
    cs = spans.calls()
    if cs is None:
        return None
    return sum(root["host_ms"] - sum(r["host_ms"] for r in stages if r["name"] == "amr.host_read")
               for root, stages in cs) / len(cs)
