"""The fused TTA header's bf16 kernel (`header_bf16_kernel`): its bound
from the call's shapes (`work.header_bound_s`: bytes at 3.35 TB/s against
FLOPs at 989 TFLOP/s) over its mean device time in the traced window (%)."""
from portbench import work

KERNEL = "header_bf16_kernel"


def read(run):
    rec, cell = run.rec, run.cell
    if rec.trace is None:
        return None
    times = [b - a for a, b, name in rec.trace.device if KERNEL in name]
    if not times:
        return None
    m = cell.config["model"]
    c0, c1 = m["context_layers"][:2]
    H, W = m["voxel"]["bev_shape"][:2]
    bound_s = work.header_bound_s(cell.traffic["streams"], m["seq_num"],
                                  H // 2, W // 2, c0, c1, 2)
    return 100.0 * bound_s / (sum(times) / len(times) / 1e6)
