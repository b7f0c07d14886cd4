"""Device-to-host reads a call on the decode path (each tier's flag in
``_scan_tiered``, ``pack_bits_from``'s starts, the ladders' ``found``):
the program's counter ``host_reads``, as each call's record holds it."""

from portbench import spans


def read(ctx):
    return spans.mean_count("host_reads")
