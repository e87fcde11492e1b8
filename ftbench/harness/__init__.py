"""The benchmark's general machinery: the cell's files found by name
(`spec`), the traffic generator (`traffic`), one run of a cell (`bench`),
host spans around the program's layers (`spans`), the device trace
(`trace`) and the comparison that decides `correct` (`check`)."""
