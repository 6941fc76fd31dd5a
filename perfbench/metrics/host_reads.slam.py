"""host_reads.slam: the calls that waited for the card (device-to-host
reads, synchronous copies to it) per frame, from the ``host_reads``
counter of the program's span recorder."""

from perfbench.harness import program_spans as ps


def read(run):
    return ps.mean(r.count("host_reads") for r in ps.frames(run))
