"""The loops the measured window drives, one module per kind of traffic
(named by a traffic file's ``loop``).  Each defines ``Loop(run)`` with
``setup()``, ``unit()`` (one unit of work, on the program's normal
path), ``drain()``, ``end_to_end(seconds)``, ``release()`` (drops the
program's state, keeps the sampled outputs) and ``readings(control)``
(the numbers compared with the reference; with ``control`` the
reference at TF32 in the program's place), and counts ``units``,
``steps`` (model steps), ``rows`` (rows a step), ``attempted`` and
``failed``."""
