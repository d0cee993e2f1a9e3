"""gather_segsum_roofline, % (device trace): ``gather_segsum`` (PageRank's
inner loop) against its memory bound, 12 bytes an edge and 8 a vertex at
3.35 TB/s; see ``lsmbench/segment_roofline.py``."""
from lsmbench.segment_roofline import share


def read(run):
    return share(run, "SumOp")
