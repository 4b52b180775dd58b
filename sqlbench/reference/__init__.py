"""The plain reference: numpy over the generated columns, one module a
template (`answer(tables, params, precision)`), and frozen copies of the
arithmetic the benchmark takes from elsewhere. It imports nothing of the
program."""
