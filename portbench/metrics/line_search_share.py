"""% of the traced jobs' untraced wall spent in the MvNMF line search (the
program's mvnmf.line_search spans: its trials and the read that ends each
round). None where the program has no such span."""
from portbench.program_record import calls, share_of_wall, spans


def read(ctx):
    found = calls(ctx)
    if not found or not spans(found, "mvnmf.line_search"):
        return None
    return share_of_wall(ctx, "mvnmf.line_search")
