"""extract_csr_s.twilight (s, program span): the host CSRs built from the
relaxations' top-k lists a family, one pair at a time (spans
consistency.csr and qp_consistency.csr)."""
from msabench import readers


def read(ctx):
    return readers.mean_timer(ctx, 'consistency.csr', 'qp_consistency.csr')
