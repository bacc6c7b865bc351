"""Entry ``train_step``: the port's ``make_train_step`` on one card, or on
one rank a card of a cell on several (data parallelism)."""
from portbench import session


def run(ctx):
    return session.train(ctx)
