"""Logging configuration for training runs.

Port of ``safelife_tpu/training/logging_setup.py``: ``setup_logging``
(``:18-78``, console plus the run's ``training.log``, for the ``training``
and ``safelife_tpu_torch`` loggers) and ``setup_data_logger`` (``:81-99``,
one cached :class:`~..loggers.SafeLifeLogger` per run directory and episode
type). ``save_code_to_wandb`` is left out with the CLI's ``--wandb``.
"""

import logging
import logging.config
import os
from functools import lru_cache

from ..loggers import SafeLifeLogger
from .global_config import config


def setup_logging(data_dir, debug=False, rank=None):
    """Configure the ``training``/``safelife_tpu_torch`` loggers (console +
    optional ``training.log`` file in the run directory). With a ``rank``
    (a multi-process run) each line starts with ``[rank N]``."""
    handlers = ['console']
    tag = '' if rank is None else '[rank %d] ' % rank
    logging_config = {
        'version': 1,
        'disable_existing_loggers': False,
        'formatters': {
            'simple': {
                'format': tag + '{levelname:8s} {message}',
                'style': '{',
            },
            'dated': {
                'format': tag + '{asctime} {levelname} '
                          '({filename}:{lineno}) {message}',
                'style': '{',
                'datefmt': '%Y-%m-%d %H:%M:%S',
            },
        },
        'handlers': {
            'console': {
                'class': 'logging.StreamHandler',
                'level': 'INFO',
                'stream': 'ext://sys.stdout',
                'formatter': 'simple',
            },
        },
        'loggers': {
            'training': {
                'level': 'DEBUG' if debug else 'INFO',
                'propagate': False,
                'handlers': handlers,
            },
            'safelife_tpu_torch': {
                'level': 'DEBUG' if debug else 'INFO',
                'propagate': False,
                'handlers': handlers,
            },
        },
        'root': {
            'level': 'WARNING',
            'handlers': handlers,
        },
    }

    if data_dir is not None:
        os.makedirs(data_dir, exist_ok=True)
        logfile = os.path.join(data_dir, 'training.log')
        if not os.path.exists(logfile):
            open(logfile, 'w').close()
        handlers.append('logfile')
        logging_config['handlers']['logfile'] = {
            'class': 'logging.FileHandler',
            'level': 'INFO',
            'formatter': 'dated',
            'filename': logfile,
        }

    logging.config.dictConfig(logging_config)
    return logging.getLogger('training')


@lru_cache(maxsize=128)
def setup_data_logger(data_dir, episode_type):
    """One cached :class:`SafeLifeLogger` per (run dir, episode type)."""
    if data_dir is not None:
        os.makedirs(data_dir, exist_ok=True)
    train_run = config.setdefault('run_type', 'train') == 'train'
    return SafeLifeLogger(
        data_dir, episode_type,
        summary_writer='auto' if train_run else False)
