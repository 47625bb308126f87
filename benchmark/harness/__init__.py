"""The benchmark's harness: the cell's spec (``spec``), the camera traffic
(``traffic``), the two sides' scene types (``sides``), the frame loop
(``loop``), the reduction of the device trace (``trace``), the work counts
and peaks of the rooflines (``work``), the comparison that decides
``correct`` (``check``) and one run of a cell (``cell``)."""
