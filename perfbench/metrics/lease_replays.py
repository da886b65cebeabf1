"""lease_replays (count): requests the pool leased again (replays) plus
renewals it refused (lost leases) during the window."""


def read(run):
    s0, s1 = run["stats0"], run["stats1"]
    return (s1["replays"] - s0["replays"]) + (s1["lost_leases"]
                                              - s0["lost_leases"])
