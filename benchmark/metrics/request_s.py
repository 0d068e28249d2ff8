"""The window's seconds over the requests it completed (encode, prime and
generate each)."""


def read(run):
    w = run.window
    return w["seconds"] / w["requests"] if w.get("requests") else None
