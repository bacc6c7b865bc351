"""Entry ``train_step``: the port's ``make_train_step`` on one card."""
from portbench import session


def run(ctx):
    return session.train(ctx)
