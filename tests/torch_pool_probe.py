"""A dataset for the worker-pool tests that reports, for each index, the
seed its worker was given and the worker's process identity. It lives in a
module of its own, importing only the standard library, so that a spawned
worker can unpickle it without importing a test module (and jax)."""
import multiprocessing as mp
import os


class SeedProbe:
    seed = None

    def __len__(self):
        return 48

    def reseed(self, seed: int) -> None:
        self.seed = seed

    def __getitem__(self, index: int):
        return (index, self.seed, mp.current_process()._identity, os.getpid())
