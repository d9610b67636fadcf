"""Node-score kernel launches (score and score+slots) per pod bound in
the window."""


def read(m):
    if not m["pods"]:
        return None
    return m["launches"] / m["pods"]
