"""The plain reference (``vo``) and the comparison that decides ``correct``
(``judge``).  Nothing here imports the program."""
