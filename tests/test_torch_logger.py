"""The port's run logger (``training/logger.py``) under concurrent ranks:
rank 0 rewrites ``<log_path>/config`` on every change of the run state
while the other ranks of a group open a ``Logger`` (``write=False``) on the
same path and read it. A reader must see the file whole or not at all (a
half-written file failed ``loop.train`` on a rank with a JSONDecodeError)."""

import threading
import time

from myimagecaptioningmodel_tpu_torch.training.logger import Logger


def test_readers_never_see_a_half_written_config(tmp_path):
    writer = Logger(str(tmp_path), write=True)
    done, errors = threading.Event(), []

    def write():
        step = 1
        while not done.is_set():
            step += 1
            writer.epoch = step

    def read():
        while not done.is_set():
            try:
                Logger(str(tmp_path), write=False).epoch
            except ValueError as e:  # json's JSONDecodeError
                errors.append(e)
                return

    threads = [threading.Thread(target=write)] + [threading.Thread(target=read)
                                                 for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(1.5)
    done.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert Logger(str(tmp_path), write=False).epoch == writer.epoch > 2
