"""% of the traced jobs' untraced wall spent in consensus clustering and
silhouettes on the host (the program's extraction.consensus spans)."""
from portbench.program_record import share_of_wall


def read(ctx):
    return share_of_wall(ctx, "extraction.consensus")
