"""Device kernels a train step launches: the kernels in the traced span's
device trace over its steps."""


def read(rec):
    return rec["trace"]["n_kernels"] / rec["span"]["units"] if rec["span"]["units"] else None
