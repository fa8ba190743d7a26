"""Share of leaf-cache lookups (encodings and their device copies) that
hit over the window."""


def read(r):
    leaf = r.get("leaf")
    if not leaf or leaf["hits"] + leaf["misses"] <= 0:
        return None
    return 100 * leaf["hits"] / (leaf["hits"] + leaf["misses"])
