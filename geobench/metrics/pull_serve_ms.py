"""PS runtime: the port's ``global.pull_serve`` spans (the global tier
building each pull response, dense or compressed, the weights' copies
to the host included) summed over the traced rounds, in ms a round
(program span)."""

from geobench import program_spans as ps


def read(run):
    serves = ps.named(ps.spans(run) or [], "global.pull_serve")
    if not serves:
        return None
    return sum(s.dur for s in serves) / run.trace.rounds / 1e3
