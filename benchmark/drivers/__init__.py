"""One driver a way of calling the program: ``<name>.py`` holds
``make(ft, config, traffic, pool, spans)``, whose result is called with a
call's pool ids and returns their host rows (``benchmark/rows.py``)."""
