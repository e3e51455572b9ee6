"""Multiprocessing worker pool whose children's exceptions reach the
parent (port of omnihuman_tpu/omni/worker_pool.py, reference
Omnihuman/worker_pool.py:13-93).

`WorkerPool` is a `multiprocessing.pool.Pool` whose map / starmap /
map_async / apply_async wrap the function in
`AsyncWorkerExceptionsWrapper`, so an exception raised in a child comes
back to the parent with the child's traceback in its message instead of
a silent hang. `cli.extract_feature` writes its `.npy` files through it.
Pass `context=multiprocessing.get_context("spawn")` where the parent has
threads or a CUDA context: the children then start from a fresh import.
"""

from __future__ import annotations

import multiprocessing.pool
import traceback
from typing import Any, Callable, Iterable, List


class AsyncWorkerExceptionsWrapper:
    """Wraps a callable so its exceptions carry the child's traceback."""

    def __init__(self, callable_: Callable):
        self.__callable = callable_

    def __call__(self, *args, **kwargs):
        try:
            return self.__callable(*args, **kwargs)
        except Exception as e:
            raise type(e)(
                f"{e}\n--- child traceback ---\n{traceback.format_exc()}"
            ) from e


class WorkerPool(multiprocessing.pool.Pool):
    """Pool whose APIs surface child exceptions in the parent."""

    def map(self, func, iterable: Iterable, chunksize=None) -> List[Any]:
        return super().map(AsyncWorkerExceptionsWrapper(func), iterable,
                           chunksize)

    def starmap(self, func, iterable: Iterable, chunksize=None) -> List[Any]:
        return super().starmap(AsyncWorkerExceptionsWrapper(func), iterable,
                               chunksize)

    def map_async(self, func, iterable: Iterable, chunksize=None,
                  callback=None, error_callback=None):
        return super().map_async(AsyncWorkerExceptionsWrapper(func),
                                 iterable, chunksize, callback,
                                 error_callback)

    def apply_async(self, func, args=(), kwds=None, callback=None,
                    error_callback=None):
        return super().apply_async(AsyncWorkerExceptionsWrapper(func), args,
                                   kwds or {}, callback, error_callback)
