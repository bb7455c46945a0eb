"""Merge, optimizer and codec stage: the host↔device bytes every
server's ``TorchBackend.stats()`` counted in the window (``h2d_bytes``,
``d2h_bytes``, ``codec_d2h_bytes``), in MB a round."""


def read(run):
    rounds = run.result["rounds"]
    if not rounds:
        return None
    return run.result["server_bytes"] / rounds / 1e6
