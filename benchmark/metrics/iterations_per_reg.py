"""The mean of ``ICPResult.num_iterations`` over the window's
registrations: a count."""

UNIT = "iter"


def read(run):
    its = [i for call in run.iterations for i in call]
    return sum(its) / len(its) if its else None
