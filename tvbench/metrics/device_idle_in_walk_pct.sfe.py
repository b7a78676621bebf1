"""Share of the traced GOPs' walk steps (their walk_intra, walk_probe,
walk_p and walk_link spans) in which no device operation ran: whether
the card starves while the host enqueues the walk."""

from tvbench.hostpath import idle_in_names_pct

#: the walk's steps, one span each
STEPS = ("walk_intra", "walk_probe", "walk_p", "walk_link")


def read(rec):
    return idle_in_names_pct(rec, STEPS)
