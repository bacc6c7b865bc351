"""Entry ``eval_step``: the port's ``make_eval_step`` with the cell's
metric set on one card."""
from portbench import session


def run(ctx):
    return session.evaluate(ctx)
