"""k3_roofline_share: kernel K3 (the VarDCT AC entropy decode,
`ac_sections_kernel`) as a share of its roofline, in %: the least time the
H100 could take for the AC sections of every decode in the window (the
larger of the bytes over the HBM peak and the integer operations over the
int32 peak) over K3's device time in the trace.

The count comes from what the writer wrote (writers/xyb_vardct.py), not
from how the decoder lays out its work, so it reads the same whatever
implements the decode: the AC sections' bytes in; the histograms a
decoder must hold (an alias table of 2^log_alpha buckets of four 16-bit
fields a cluster, and a byte a context of the context map); the dense
int32 coefficients out (3 x 64 a block of the writer's transform map,
so a frame's partial groups count only their blocks); and
OPS_PER_TOKEN integer operations a token (the rANS step, the context's
choice, HybridUint and the store: an assumed count)."""

from portbench import peaks

UNIT = "%"
KERNEL = "ac_sections_kernel"
OPS_PER_TOKEN = 64
ALIAS_BUCKET_BYTES = 8


def count(coded) -> tuple:
    """(bytes, integer operations) of one frame's AC decode."""
    nbytes = (coded["ac_section_bytes"]
              + coded["ac_clusters"] * (1 << coded["ac_log_alpha"]) * ALIAS_BUCKET_BYTES
              + coded["ac_contexts"]
              + 3 * 64 * coded["transform"].size * 4)
    return nbytes, coded["ac_tokens"] * OPS_PER_TOKEN


def bound_s(coded) -> float:
    nbytes, ops = count(coded)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT32_OPS_PER_S)


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.device_seconds(lambda n: KERNEL in n)
    if secs <= 0:
        return None
    bound = sum(bound_s(run.pool[d.index].coded) for d in run.decodes
                if "ac_tokens" in run.pool[d.index].coded)
    return 100.0 * bound / secs if bound > 0 else None
