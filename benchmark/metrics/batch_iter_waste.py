"""The share of a batch's element-iterations spent on elements that had
stopped, over the window's batches: 1 - sum(iterations) / (B x sum of each
batch's largest), in percent. A batch runs to its slowest element."""

UNIT = "%"


def read(run):
    calls = [its for its in run.iterations if len(its) > 1]
    slots = sum(len(its) * max(its) for its in calls)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(sum(its) for its in calls) / slots)
