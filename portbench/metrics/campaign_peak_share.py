"""The least time the cell's H100s need for a campaign's sweep work
(``peaks``, from the reference's executed lane-steps, split over the
cards) as a share of the campaign's wall time, in percent."""


def read(r):
    wall = sum(r.wall_s)
    return 100.0 * sum(r.least_s) / wall if wall > 0 else None
