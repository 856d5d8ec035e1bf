"""Closed-loop drivers, one a traffic kind (the mix file's ``kind``)."""
