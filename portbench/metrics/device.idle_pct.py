"""100 - the cards' pooled busy share of the traced steps: on each card
the union of the intervals in which an operation ran, over that card's
span of those steps, from the start of its first operation to the end of
its last, both summed over the cards (the synchronize that opens the
traced stretch, and the one that closes it, are not the program's and do
not count)."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
