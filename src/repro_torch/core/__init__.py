"""Install-time and run-time planning: kernel table, tiler, plans."""
