"""% of the traced calls' untraced wall spent in the dense and the final
exposure refit (the program's assign.refit spans)."""
from portbench.program_record import share_of_wall


def read(ctx):
    return share_of_wall(ctx, "assign.refit")
