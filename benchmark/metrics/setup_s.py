"""Process start to the first record of the window: data, index build,
serialize and load, engine tables, read pool, one warm-up chunk."""


def read(run):
    return run.setup_s
