"""FinimizerIndex.load and DeviceQueryEngine.__init__ (minimizer
derivation, locate tables), synchronised, host clock."""


def read(run):
    return run.engine_init_s
